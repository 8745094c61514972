"""Per-set BLS verification on the device: the four kernels and the path
that drives them.

Counterpart of the per-set half of `lodestar_tpu/kernels/verify.py`:
`verify_each_device` (`:922`) and `_each_core` (`:1092`).  One job of N
padded single-pubkey sets runs

    mont_convert       8 planes of plain limbs -> Montgomery   (_k_mont8)
    [gather]           pubkey rows by index: torch.index_select (_gather_pk)
    [substitute]       dead lanes -> generators, torch.where   (_j_substitute)
    g2_subgroup_check  psi(sig) == -[|x|] sig per lane         (_k_sub_only)
    miller_loop x 2    (pk, H(m)) and (-G1, sig) per lane      (_k_miller)
    each_final         f1 f2 -> final exp -> is-one per lane   (_k_each_final)

Each kernel wrapper checks its operands, then runs the hand-written CUDA
kernel (`csrc/*.cu`) for CUDA tensors or the kernel's plain torch version
for CPU tensors; any other device raises.  There is no fallback from one
to the other.  `LAUNCHES[name]` counts the wrapper's kernel launches.

Planes are int32 ``[..., 12, N]`` (`kernels/layout.py`), the batch on the
last axis; an Fp2 value is ``[2, 12, N]``, an affine G2 point
``[2, 2, 12, N]`` (x, y), a Jacobian G1 point ``[3, 12, N]`` and an Fp12
value ``[12, 12, N]`` in the JAX package's leaf order.  Lane flags are
int32 ``[1, N]`` rows, as in the JAX kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..crypto import curves as GC
from ..crypto import fields as GT
from . import build as B
from . import core as C
from . import curve as CV
from . import layout as LY
from . import pairing as KP
from . import tower as TW

NL = LY.NL
ND = LY.ND

LAUNCHES: Dict[str, int] = {
    "mont_convert": 0,
    "g2_subgroup_check": 0,
    "miller_loop": 0,
    "each_final": 0,
}

# Fp multiplications per lane (per element for mont_convert) of each
# kernel, from the structure of csrc/*.cuh; tests/test_torch_csrc_host.py
# checks them against a count taken by the host build.  A 12-limb CIOS
# Montgomery product issues 12 rows x (4 x 12 multiply-adds + 1 multiply).
FP_MULS_PER_LANE = {
    "mont_convert": 1,
    "g2_subgroup_check": 1181,
    "miller_loop": 7834,
    "each_final": 8337,
}
IMAD_PER_FP_MUL = 12 * (4 * 12 + 1)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Operand checks and launch
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 planes, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        # the kernels launch on the current device's current stream
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"operands on {dev}, current CUDA device is {torch.cuda.current_device()}")
        return False
    raise ValueError(f"unsupported device {dev}")


def _shape(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(name: str, source: str, symbol: str, *args) -> None:
    fn = getattr(B.load(source), symbol)
    stream = torch.cuda.current_stream().cuda_stream
    LAUNCHES[name] += 1
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1: Montgomery ingest (_k_mont8 / _k_mont4)
# ---------------------------------------------------------------------------


def mont_convert_plain(x: torch.Tensor) -> torch.Tensor:
    return LY.digits_to_planes(C.mont_convert(LY.planes_to_digits(x)))


def mont_convert(x: torch.Tensor) -> torch.Tensor:
    """Plain limb planes [..., 12, N] (any integers below 2^384) ->
    canonical Montgomery planes x * R mod p."""
    if x.dim() < 2 or x.shape[-2] != NL:
        raise ValueError(f"mont_convert: expected [..., {NL}, N], got {tuple(x.shape)}")
    if _on_cpu(x):
        return mont_convert_plain(x)
    out = torch.empty_like(x)
    n = x.shape[-1]
    planes = x.numel() // (NL * n) if n else 0
    _launch("mont_convert", "mont", "lt_mont_convert", x.data_ptr(), out.data_ptr(), planes, n)
    return out


# ---------------------------------------------------------------------------
# K2: G2 subgroup check (_k_sub_only)
# ---------------------------------------------------------------------------


def g2_subgroup_check_plain(q: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    d = LY.planes_to_digits(q)
    ok = CV.g2_subgroup_check((d[0], d[1]), q_inf[0] != 0)
    return ok.to(torch.int32)[None, :]


def g2_subgroup_check(q: torch.Tensor, q_inf: torch.Tensor) -> torch.Tensor:
    """Affine G2 points [2, 2, 12, N] and infinity flags [1, N] -> int32
    [1, N], 1 where psi(Q) == -[|x|]Q or Q is infinity."""
    n = q.shape[-1]
    _shape(q, (2, 2, NL, n), "g2_subgroup_check q")
    _shape(q_inf, (1, n), "g2_subgroup_check q_inf")
    if _on_cpu(q, q_inf):
        return g2_subgroup_check_plain(q, q_inf)
    out = torch.empty((1, n), dtype=torch.int32, device=q.device)
    _launch(
        "g2_subgroup_check", "subgroup", "lt_g2_subgroup_check",
        q.data_ptr(), q_inf.data_ptr(), out.data_ptr(), n,
    )
    return out


# ---------------------------------------------------------------------------
# K3: Miller loop (_k_miller)
# ---------------------------------------------------------------------------


def miller_loop_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pd, qd = LY.planes_to_digits(p), LY.planes_to_digits(q)
    f = KP.miller_loop((pd[0], pd[1], pd[2]), (qd[0], qd[1]))
    return LY.digits_to_planes(f.reshape(12, ND, f.shape[-1]))


def miller_loop(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jacobian G1 [3, 12, N] x affine G2 [2, 2, 12, N] -> Fp12 [12, 12, N]
    (the conjugated Miller value of `lodestar_tpu/kernels/pairing.py`)."""
    n = p.shape[-1]
    _shape(p, (3, NL, n), "miller_loop p")
    _shape(q, (2, 2, NL, n), "miller_loop q")
    if _on_cpu(p, q):
        return miller_loop_plain(p, q)
    f = torch.empty((12, NL, n), dtype=torch.int32, device=p.device)
    _launch("miller_loop", "miller", "lt_miller_loop", p.data_ptr(), q.data_ptr(), f.data_ptr(), n)
    return f


# ---------------------------------------------------------------------------
# K4: per-lane product, final exponentiation, is-one (_k_each_final)
# ---------------------------------------------------------------------------


def each_final_plain(live: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    n = f1.shape[-1]
    a = LY.planes_to_digits(f1).reshape(2, 3, 2, ND, n)
    b = LY.planes_to_digits(f2).reshape(2, 3, 2, ND, n)
    f = TW.mul12(a, b)
    f = TW.select(live[0] != 0, f, TW.one12(n, f.device))
    return TW.is_one12(KP.final_exponentiation(f)).to(torch.int32)[None, :]


def each_final(live: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Per lane: f1 f2 (dead lanes -> 1), final exponentiation, is-one ->
    int32 [1, N]."""
    n = f1.shape[-1]
    _shape(live, (1, n), "each_final live")
    _shape(f1, (12, NL, n), "each_final f1")
    _shape(f2, (12, NL, n), "each_final f2")
    if _on_cpu(live, f1, f2):
        return each_final_plain(live, f1, f2)
    ok = torch.empty((1, n), dtype=torch.int32, device=f1.device)
    _launch(
        "each_final", "final", "lt_each_final",
        live.data_ptr(), f1.data_ptr(), f2.data_ptr(), ok.data_ptr(), n,
    )
    return ok


# ---------------------------------------------------------------------------
# The per-set path
# ---------------------------------------------------------------------------

_CONSTS: dict = {}


def _const_planes(device) -> dict:
    """Generator planes [12, 1] (Montgomery) for substitution and -G1."""
    key = str(device)
    c = _CONSTS.get(key)
    if c is None:
        def col(v):
            return torch.from_numpy(LY.encode_batch([v])).to(device)

        g2x, g2y = GC.G2_GEN
        c = {
            "g1x": col(GC.G1_GEN[0]),
            "g1y": col(GC.G1_GEN[1]),
            "neg_g1y": col(GT.fp_neg(GC.G1_GEN[1])),
            "one": col(1),
            "g2": torch.stack(
                [torch.stack([col(g2x[0]), col(g2x[1])]), torch.stack([col(g2y[0]), col(g2y[1])])]
            ),
        }
        _CONSTS[key] = c
    return c


def _check_single(idx) -> None:
    if idx.dim() != 2 or idx.shape[1] != 1:
        raise ValueError(
            "aggregate sets (K > 1) need the pubkey-aggregation kernel "
            "(_k_agg_pk), which a later slice of the port adds"
        )


def _gather_pk(table_x, table_y, idx):
    """Per-set pubkey, K = 1: rows of the device table by index ->
    Jacobian planes [3, 12, N] (Z = 1) and the infinity mask (none)."""
    _check_single(idx)
    rows = idx[:, 0].to(torch.int64)
    px = torch.index_select(table_x, 1, rows)
    py = torch.index_select(table_y, 1, rows)
    n = rows.shape[0]
    pz = _const_planes(table_x.device)["one"].expand(NL, n)
    return torch.stack([px, py, pz]), torch.zeros(n, dtype=torch.bool, device=table_x.device)


def _substitute(live, pk, sig):
    """Dead lanes -> generator points (keeps every lane on the curve)."""
    c = _const_planes(pk.device)
    g1 = torch.stack([c["g1x"], c["g1y"], c["one"]])
    return torch.where(live, pk, g1), torch.where(live, sig, c["g2"])


def each_operands(table_x, table_y, idx, msg, sig, sig_bad, valid) -> dict:
    """The kernel operands of one per-set job, from Montgomery message and
    signature points [2, 2, 12, N]: gather the pubkeys, substitute
    generators into dead lanes, and lay out the four kernel launches."""
    n = valid.shape[0]
    pk, pk_inf = _gather_pk(table_x, table_y, idx)
    live = (valid != 0) & ~pk_inf & ~sig_bad
    pk, sig = _substitute(live, pk, sig)
    c = _const_planes(pk.device)
    neg_g1 = torch.stack([c["g1x"], c["neg_g1y"], c["one"]]).expand(3, NL, n)
    return {
        "live": live,
        "sub": (sig.contiguous(), torch.zeros((1, n), dtype=torch.int32, device=pk.device)),
        "miller_pk": (pk.contiguous(), msg.contiguous()),
        "miller_sig": (neg_g1.contiguous(), sig.contiguous()),
        "live_row": live[None, :].to(torch.int32),
    }


def _each_core(table_x, table_y, idx, msg, sig, sig_bad, valid):
    ops = each_operands(table_x, table_y, idx, msg, sig, sig_bad, valid)
    sub = g2_subgroup_check(*ops["sub"])
    f1 = miller_loop(*ops["miller_pk"])
    f2 = miller_loop(*ops["miller_sig"])
    ok = each_final(ops["live_row"], f1, f2)
    return ((ok[0] != 0) & (sub[0] != 0) & ops["live"]) | ~(valid != 0)


def verify_each_device(table_x, table_y, idx, planes, sig_inf, valid):
    """Independent per-set verdicts: e(pk_i, H_i) e(-G1, sig_i) == 1 and
    sig_i in G2, per lane; padding lanes True.

    table_x, table_y: int32 [12, V] Montgomery pubkey planes;
    idx: int [N, 1] table rows (K = 1: single-pubkey sets only);
    planes: int32 [8, 12, N] PLAIN limbs of H(m) x0, x1, y0, y1 and
    sig x0, x1, y0, y1; sig_inf, valid: int32 [N].
    Returns bool [N]: ((ok & sub & live) | ~valid), as `_each_core`.
    """
    n = valid.shape[0]
    _shape(planes, (8, NL, n), "verify_each_device planes")
    _check_single(idx)
    m = mont_convert(planes)
    msg = m[:4].reshape(2, 2, NL, n)
    sig = m[4:].reshape(2, 2, NL, n)
    return _each_core(table_x, table_y, idx, msg, sig, sig_inf != 0, valid)
