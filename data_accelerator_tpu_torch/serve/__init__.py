"""Control-plane pieces the engine needs: the shared object store
(``objectstore.py``). The rest of the JAX package's ``serve/`` (flow
lifecycle, config generation, jobs) is not ported yet."""

from .objectstore import ObjectStoreClient, ObjectStoreServer

__all__ = ["ObjectStoreClient", "ObjectStoreServer"]
