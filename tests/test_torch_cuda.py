"""The port's CUDA kernels on the card (marker `cuda`; each test skips
without a CUDA device).

Imports nothing of JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit against its plain torch version on the
same device tensors, and the per-set verifier (default device: CUDA)
against the crypto oracle.  chip_smoke.py does the same at the main
path's shapes with a 1M-row table.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.signature_set import SignatureSet
from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier
from lodestar_tpu_torch.crypto import curves as GC
from lodestar_tpu_torch.crypto import fields as GT
from lodestar_tpu_torch.crypto import hash_to_curve as GH
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(0xCDA)
N = 40


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def planes(arr, dev):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


@pytest.fixture(scope="module")
def points(dev):
    qs = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(N)]
    ps = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(N)]
    q = planes(np.stack([np.stack([LY.encode_batch([p[c][k] for p in qs]) for k in range(2)]) for c in range(2)]), dev)
    p = planes(np.stack([LY.encode_batch([x for x, _ in ps]), LY.encode_batch([y for _, y in ps]),
                         LY.encode_batch([1] * N)]), dev)
    return p, q


def test_mont_convert_on_card(dev):
    vals = [int.from_bytes(RNG.bytes(48), "little") for _ in range(2 * N)]
    x = planes(LY.encode_plain_batch(vals).reshape(LY.NL, 2, N).transpose(1, 0, 2), dev)
    before = KV.LAUNCHES["mont_convert"]
    out = KV.mont_convert(x)
    assert KV.LAUNCHES["mont_convert"] == before + 1
    assert torch.equal(out, KV.mont_convert_plain(x))


def test_subgroup_miller_final_on_card(dev, points):
    p, q = points
    q_inf = torch.zeros((1, N), dtype=torch.int32, device=dev)
    assert torch.equal(KV.g2_subgroup_check(q, q_inf), KV.g2_subgroup_check_plain(q, q_inf))
    f = KV.miller_loop(p, q)
    assert torch.equal(f, KV.miller_loop_plain(p, q))
    live = torch.ones((1, N), dtype=torch.int32, device=dev)
    live[0, 1] = 0
    ok = KV.each_final(live, f, f)
    assert torch.equal(ok, KV.each_final_plain(live, f, f))
    torch.cuda.synchronize()


def test_verifier_on_card(dev):
    sks = [scalar() for _ in range(3)]
    pks = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk) for sk in sks]
    table = PubkeyTable()
    table.register(pks)
    h = GH.hash_to_g2(b"on-card")
    sig = [GC.scalar_mul(GC.FP2_OPS, h, sk) for sk in sks]
    sets = [SignatureSet.single(0, h, sig[0]), SignatureSet.single(1, h, sig[2]),
            SignatureSet.single(2, h, None), SignatureSet.single(2, h, sig[2])]
    v = TorchBlsVerifier(table)
    assert v.device.type == "cuda"
    KV.reset_launches()
    assert v.verify_signature_sets_individually(sets) == [True, False, False, True]
    assert min(KV.LAUNCHES.values()) > 0
    assert v._device_canary()
