"""Web UI layer: dashboard server + single-page app.

reference: Website/ — Node Express server (REST fan-out to the Gateway,
Redis metric poller pushing socket.io 'datapoints') plus React packages
(datax-home/-pipeline/-query/-metrics/-jobs) composed via
web.composition.json. Here: a Python HTTP server (server.py) serving a
static SPA (static/) with Server-Sent Events for the live metric feed.

Copy of the JAX package's ``web/__init__.py``.
"""

from .server import WebsiteServer

__all__ = ["WebsiteServer"]
