"""Observability: stats collection → storage → web dashboard (port of
the JAX package's ``ui/``; reference ``deeplearning4j-ui-parent``:
StatsListener → StatsStorage → PlayUIServer).  The statistics are
computed with torch on the network's device (``stats``); the rest is
host code whose files, JSON and HTML equal the JAX package's."""
from .components import (ChartHistogram, ChartHorizontalBar, ChartLine,
                         ChartScatter, ChartStackedArea, ChartTimeline,
                         ComponentDiv, ComponentTable, ComponentText,
                         DecoratorAccordion, StyleAccordion, StyleChart,
                         StyleDiv, StyleTable, StyleText, component_from_json,
                         component_to_json, render_page)
from .connection import UiConnectionInfo
from .renders import (coords_to_csv_lines, embedding_coords,
                      render_word_scatter, upload_tsne)
from .server import RemoteUIStatsStorageRouter, UIServer
from .stats import StatsListener, StatsReport, array_stats
from .storage import (FileStatsStorage, InMemoryStatsStorage,
                      SqliteStatsStorage, StatsStorage)

__all__ = ["StatsListener", "StatsReport", "array_stats", "StatsStorage",
           "InMemoryStatsStorage", "FileStatsStorage", "SqliteStatsStorage",
           "UIServer",
           "RemoteUIStatsStorageRouter", "UiConnectionInfo", "ChartLine",
           "ChartScatter", "ChartHistogram", "ChartStackedArea",
           "ChartTimeline", "ChartHorizontalBar", "ComponentTable",
           "ComponentText", "ComponentDiv", "DecoratorAccordion",
           "StyleChart", "StyleTable", "StyleText", "StyleDiv",
           "StyleAccordion", "component_to_json", "component_from_json",
           "render_page", "embedding_coords",
           "coords_to_csv_lines", "render_word_scatter", "upload_tsne"]
