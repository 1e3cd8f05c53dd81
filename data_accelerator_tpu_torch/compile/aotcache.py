"""``objstore://`` URL parsing for the port's object-store clients (the
state-snapshot mirror, fleet frames, shared machine profiles).

A trimmed copy of the JAX package's ``compile/aotcache.py``: only
``_parse_objstore_url`` and ``compile_conf_for``. The rest of that
module is JAX's persistent compilation cache, which eager PyTorch has no
counterpart for: ``process.compile.cachedir``/``cacheurl`` are read by
nothing here. ``compile_conf_for`` stays so that the control plane's
REST kernel pool and its one-box server build the same conf keys as the
JAX package's (``analysis/confspec.py`` marks both ``read=False``).
"""

from __future__ import annotations

from typing import Optional, Tuple


def compile_conf_for(cache_dir: str,
                     cache_url: Optional[str] = None) -> dict:
    """The ``datax.job.process.compile.*`` conf keys that arm this
    cache for a kernel pool — the one way LiveQuery surfaces (REST
    kernel pool, serving-plane warm cache, one-box server) build their
    shared compile conf, so the layers can't drift on key names."""
    conf = {"datax.job.process.compile.cachedir": cache_dir}
    if cache_url:
        conf["datax.job.process.compile.cacheurl"] = cache_url
    return conf


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
