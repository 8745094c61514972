"""DB layer of the port: the native ordered KV controller + bucketed
repositories (copies of the JAX package's `lodestar_tpu/db/`).

Mirror of the reference's `@lodestar/db` (reference:
packages/db/src/controller/level.ts for the controller surface,
db/src/abstractRepository.ts + schema.ts for bucket-prefixed
repositories, and packages/beacon-node/src/db/ for BeaconDb): the
storage engine is the C++ ordered KV store in
`lodestar_tpu_torch/native/kvstore.cpp` (the LevelDB-dependency analog),
built with the host C++ compiler at the first durable open and loaded
via ctypes; `path=None` is the explicit in-memory store.
"""

from .controller import KvController  # noqa: F401
from .repository import Bucket, Repository  # noqa: F401
from .beacon_db import BeaconDb  # noqa: F401
