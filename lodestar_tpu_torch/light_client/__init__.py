"""Light client of the port: sync-committee-based header tracking (a copy
of the JAX package's `lodestar_tpu/light_client/lightclient.py`; its
transport is not ported yet).

Mirror of the reference's `@lodestar/light-client` (reference:
packages/light-client/src/index.ts + validation.ts): bootstrap from a
trusted header + current sync committee, then advance optimistic and
finalized headers by verifying LightClientUpdates — sync-committee
BLS aggregate signatures over attested headers with a 2/3 participation
threshold, next-committee rotation at period boundaries.
"""

from .lightclient import Lightclient, LightClientUpdate, ValidationError  # noqa: F401
