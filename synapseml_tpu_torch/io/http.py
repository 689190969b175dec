"""HTTP requests and responses as data.

The port's copy of the schema half of the reference package's
``io/http.py`` (ref: HTTPSchema.scala request/response case classes):
the serving front end parks an :class:`HTTPRequestData` on each queued
request and routes an :class:`HTTPResponseData` back. The client
transformers (``HTTPTransformer``, the retry ladder, PowerBI) are not
ported yet (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

__all__ = ["HTTPRequestData", "HTTPResponseData"]


@dataclasses.dataclass
class HTTPRequestData:
    """One HTTP request as data (ref: HTTPSchema.scala HTTPRequestData)."""
    url: str
    method: str = "POST"
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    entity: Optional[bytes] = None

    @staticmethod
    def from_any(v: Any) -> "HTTPRequestData":
        if isinstance(v, HTTPRequestData):
            return v
        if isinstance(v, dict):
            ent = v.get("entity")
            if isinstance(ent, str):
                ent = ent.encode("utf-8")
            return HTTPRequestData(
                url=v["url"], method=v.get("method", "POST"),
                headers=dict(v.get("headers") or {}), entity=ent)
        raise TypeError(f"cannot interpret {type(v)} as HTTPRequestData")


@dataclasses.dataclass
class HTTPResponseData:
    """One HTTP response as data (ref: HTTPSchema.scala HTTPResponseData)."""
    status_code: int
    reason: str = ""
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    entity: Optional[bytes] = None

    @property
    def text(self) -> str:
        return (self.entity or b"").decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.text)

