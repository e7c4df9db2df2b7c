"""A minimal JSON-over-HTTP client on the standard library.

The reference's agent posts through ``requests.Session``; the port must run
where ``requests`` is not installed, so its default session is this
``urllib`` one. ``UrllibSession.post(url, json=, timeout=)`` returns an
object with ``status_code``, ``json()`` and ``text``, as ``requests`` does:
an HTTP error status comes back as a response, and a transport failure
(refused connection, timeout, bad URL) raises, which the agent turns into
its status-0 transport error. A session holds no connection state, so each
thread may own one or share one.
"""

from __future__ import annotations

import base64
import json as _json
import urllib.error
import urllib.request
from typing import Any, Optional, Tuple


class Response:
    """The part of ``requests.Response`` the agent reads."""

    def __init__(self, status_code: int, body: bytes) -> None:
        self.status_code = status_code
        self.content = body

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        """The body parsed as JSON; ValueError when it is not JSON."""
        return _json.loads(self.text)


def post_json(url: str, body: Any, timeout: float,
              auth: Optional[Tuple[str, str]] = None) -> Response:
    """POST ``body`` as JSON; an HTTP error status is a response, a
    transport failure raises ``OSError`` (``urllib.error.URLError``,
    ``socket.timeout``) or ``ValueError`` (a malformed URL)."""
    headers = {"Content-Type": "application/json"}
    if auth is not None:
        token = base64.b64encode(f"{auth[0]}:{auth[1]}".encode()).decode("ascii")
        headers["Authorization"] = f"Basic {token}"
    req = urllib.request.Request(url, data=_json.dumps(body).encode("utf-8"),
                                 headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return Response(resp.status, resp.read())
    except urllib.error.HTTPError as exc:
        with exc:
            return Response(exc.code, exc.read())


class UrllibSession:
    """The agent's default session: ``post(url, json=, timeout=)``."""

    def post(self, url: str, json: Any = None, timeout: float = 10.0) -> Response:  # noqa: A002
        return post_json(url, json, timeout)
