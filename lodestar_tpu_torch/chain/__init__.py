"""The chain-side helpers the port's slasher needs (copies of the JAX
package's `lodestar_tpu/chain/`)."""
