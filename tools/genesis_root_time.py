"""The genesis registry root of 1,048,576 validators, three ways, on one card.

    python3 tools/genesis_root_time.py [--rows 1048576]

A diagnostic beside the package, not part of it.  Builds chip_smoke.py's
genesis registry (row r holds key r % 64 of its 64 seeded keys) with the
port's `create_genesis_state` and times its `genesis_validators_root`
three ways, each held equal to the others: the state-root engine's
validators cell on the card (`DeviceMerkleBackend`: one `validator_roots`
launch and the tree's levels, what `create_genesis_state` runs), the same
cell on the host path (hashlib), and the host SSZ list type over
`validators_value()` (one Python dict a validator, the JAX package's
`genesis.py:172-174`).  Prints one JSON line with the card's name and
power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SEED = 0x10DE57A8  # chip_smoke.py's
N_KEYS = 64


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("genesis_root_time: no CUDA device", file=sys.stderr)
        return 2
    from lodestar_tpu_torch.config import MAINNET_CHAIN_CONFIG, create_chain_config
    from lodestar_tpu_torch.crypto import bls as GB
    from lodestar_tpu_torch.crypto import curves as GC
    from lodestar_tpu_torch.params import ACTIVE_PRESET, ForkName
    from lodestar_tpu_torch.ssz import List as SszList
    from lodestar_tpu_torch.ssz import device_backend as DB
    from lodestar_tpu_torch.state_transition import create_genesis_state
    from lodestar_tpu_torch.state_transition.state_root import _ValidatorsCell
    from lodestar_tpu_torch.types import Validator

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(SEED)
    comp = [GC.g1_compress(GB.sk_to_pk(GB.keygen(rng.bytes(32)))) for _ in range(N_KEYS)]
    keys = [comp[r % N_KEYS] for r in range(args.rows)]
    cfg = create_chain_config(MAINNET_CHAIN_CONFIG, fork_epochs={ForkName.altair: 0})
    backend = DB.DeviceMerkleBackend()
    DB.set_backend(backend)
    t = time.perf_counter()
    state = create_genesis_state(cfg, keys)
    genesis_s = time.perf_counter() - t

    out = {"rows": args.rows, "card": card, "genesis_s": genesis_s}
    roots = {}
    _ValidatorsCell().root(state)  # the first launch builds nothing: B.load ran in the backend
    for label, backend_of in (("engine_card", backend), ("engine_host", None)):
        DB.set_backend(backend_of)
        torch.cuda.synchronize()
        t = time.perf_counter()
        roots[label] = _ValidatorsCell().root(state)
        torch.cuda.synchronize()
        out[label + "_ms"] = (time.perf_counter() - t) * 1e3
    DB.set_backend(None)
    t = time.perf_counter()
    roots["ssz_list_host"] = SszList(Validator, ACTIVE_PRESET.VALIDATOR_REGISTRY_LIMIT).hash_tree_root(
        state.validators_value())
    out["ssz_list_host_ms"] = (time.perf_counter() - t) * 1e3
    DB.reset_backend()
    if len({*roots.values(), state.genesis_validators_root}) != 1:
        raise AssertionError(f"the registry roots differ: {roots}")
    out["root"] = state.genesis_validators_root.hex()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
