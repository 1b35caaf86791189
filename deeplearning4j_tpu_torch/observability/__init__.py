"""Clock and sliding-window quantiles (port of the parts of
``observability/`` the generation engine reads).  The metrics registry,
health monitor and flight recorder are not ported yet."""
