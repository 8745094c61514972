"""Network-side scheduling components of the port: gossip queues +
processor (copies of the JAX package's `lodestar_tpu/network/`
gossip_queues.py and processor.py; the processor's deferred forward
queue of `forwarding.py` comes with the gossip handlers that register
deferrals).

Only the scheduling layer is reproduced here — the libp2p/gossipsub
transport itself stays off the device path (SURVEY.md §2.4 P9).
`reqresp_protocols` holds only the light-client wire containers that the
light-client server persists its updates in.  The rest of the JAX
package's `network/` (gossip encoding, handlers, peers, scoring, req/resp,
forwarding) is not ported yet.
"""

from .gossip_queues import (  # noqa: F401
    GossipQueue,
    GossipType,
    create_gossip_queues,
)
from .processor import (  # noqa: F401
    NetworkProcessor,
    PendingGossipMessage,
)
