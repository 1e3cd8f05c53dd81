"""``objstore://`` URL parsing for the port's object-store clients (the
state-snapshot mirror, fleet frames, shared machine profiles).

A trimmed copy of the JAX package's ``compile/aotcache.py``: only
``_parse_objstore_url``. The rest of that module is JAX's persistent
compilation cache, which eager PyTorch has no counterpart for
(``process.compile.cachedir``/``cacheurl`` are read by nothing here).
"""

from __future__ import annotations

from typing import Tuple


def _parse_objstore_url(url: str) -> Tuple[str, str, str]:
    """objstore://host:port/bucket/prefix -> (endpoint, bucket, prefix)."""
    if url.startswith("objstore+https://"):
        scheme, rest = "https", url[len("objstore+https://"):]
    elif url.startswith("objstore://"):
        scheme, rest = "http", url[len("objstore://"):]
    else:
        raise ValueError(f"not an objstore URL: {url!r}")
    host, _, bucket_key = rest.partition("/")
    bucket, _, prefix = bucket_key.partition("/")
    if not bucket:
        raise ValueError(f"objstore URL needs a bucket: {url!r}")
    return f"{scheme}://{host}", bucket, prefix.strip("/")
