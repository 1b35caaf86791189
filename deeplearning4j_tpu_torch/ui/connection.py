"""UI endpoint descriptor (port of ``ui/connection.py``; reference ``deeplearning4j-core/.../ui/
UiConnectionInfo.java``): where a training process should POST its stats."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class UiConnectionInfo:
    address: str = "localhost"
    port: int = 9000
    path: str = ""
    https: bool = False
    session_id: str = ""

    def get_first_part(self) -> str:
        scheme = "https" if self.https else "http"
        return f"{scheme}://{self.address}:{self.port}"

    def get_second_part(self, suffix: str = "") -> str:
        parts = [p for p in (self.path.strip("/"), suffix.strip("/")) if p]
        return "/" + "/".join(parts) if parts else "/"

    def get_full_address(self, suffix: str = "") -> str:
        return self.get_first_part() + self.get_second_part(suffix)
