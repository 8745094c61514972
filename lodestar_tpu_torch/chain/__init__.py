"""The chain-side pieces of the port (copies of the JAX package's
`lodestar_tpu/chain/`): the slot clock, the seen caches the node's gossip
dedup reads, and the op-pool helper the slasher needs.  BeaconChain,
regen, the archiver and the validation family are not ported yet.
"""
