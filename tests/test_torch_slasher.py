"""The port's slasher (`lodestar_tpu_torch/slasher/`, `kernels/spans.py`,
`csrc/spans.cu`) against the JAX package's (`lodestar_tpu/slasher/`).

  - the plain span update against JAX's `span_update_planes` under
    `jax.jit` on the CPU, exactly, on random planes and the edges (a
    source below the window, source == target, columns past the window,
    no row, every row);
  - the host build of `csrc/spans.cu` (the kernel's own code, compiled
    with the host C++ compiler) against the plain version, both row orders;
  - `TorchSpanState(device="cpu")` against `JaxSpanState` and the numpy
    `SpanState` over random apply, advance and growth sequences;
  - the JAX `AttesterSlasher` with a `TorchSpanState` assigned as its
    spans against the JAX naive detector;
  - the port's detectors and `SlasherService` against the JAX ones on the
    same seeded streams (a stub chain, a dict-backed db): detections,
    op-pool inserts, store keys, restart replay, and the golden cases of
    tests/test_slasher.py on both.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import slasher as JSL
from lodestar_tpu import types as JT
from lodestar_tpu.slasher import device as JDEV
from lodestar_tpu.slasher import service as JSVC
from lodestar_tpu_torch import slasher as TSL
from lodestar_tpu_torch import types as TT
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import spans as SP
from lodestar_tpu_torch.slasher import service as TSVC

jax = pytest.importorskip("jax")

MIN_S, MAX_S = int(TSL.batch.MIN_SPAN_SENTINEL), int(TSL.batch.MAX_SPAN_SENTINEL)


def _planes(rng, v, h):
    """Random planes around real span values, sentinels among them."""
    mn = rng.integers(-4, 80, (v, h)).astype(np.int32)
    mx = rng.integers(-4, 80, (v, h)).astype(np.int32)
    mn[rng.random((v, h)) < 0.3] = MIN_S
    mx[rng.random((v, h)) < 0.3] = MAX_S
    return mn, mx


# (s_col, t_col, rows) with H = 64: inside, a source below the window
# (only the max update lands), source == target, past the window, no row,
# every row, repeated rows
H = 64
EDGES = {
    "inside": (5, 20, [3, 0, 36, 17]),
    "below_window": (-7, 12, [1, 2, 30]),
    "source_eq_target": (9, 9, [4, 5]),
    "source_eq_target_0": (0, 0, [4]),
    "target_last_column": (10, H - 1, [0, 36]),
    "target_past_window": (50, H + 30, [6]),
    "source_past_window": (H + 3, H + 9, [7, 8]),
    "both_below": (-9, -2, [1]),
    "no_row": (3, 9, []),
    "every_row": (12, 40, list(range(37))),
    "repeated_rows": (2, 30, [5, 5, 9, 5]),
}


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(JDEV.span_update_planes)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_plain_span_update_equals_jax(jitted, case):
    s, t, rows = EDGES[case]
    rng = np.random.default_rng(len(case) * 7 + s)
    mn, mx = _planes(rng, 37, H)
    mask = np.zeros(37, bool)
    mask[rows] = True
    jm, jx = jitted(mn, mx, mask, np.int32(s), np.int32(t))
    pm, px = SP.span_update_planes_plain(torch.from_numpy(mn), torch.from_numpy(mx), torch.from_numpy(mask), s, t)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    assert pm.dtype == px.dtype == torch.int32
    # the wrapper on CPU tensors: in place, the same planes
    wm, wx = torch.from_numpy(mn.copy()), torch.from_numpy(mx.copy())
    SP.span_update(wm, wx, torch.tensor(rows, dtype=torch.int64), s, t)
    assert torch.equal(wm, pm) and torch.equal(wx, px)
    # only the touched columns of the listed rows can differ
    last = SP.touched_columns(H, s, t)
    assert np.array_equal(pm.numpy()[:, last:], mn[:, last:]) and np.array_equal(px.numpy()[:, last:], mx[:, last:])
    n_min, n_max = SP.cells_updated(H, s, t)
    cols = np.arange(H)
    assert n_min == int((cols < s).sum()) and n_max == int(((cols > s) & (cols < t)).sum())


@pytest.fixture(scope="module")
def host_lib():
    return B.load_host("spans")


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("case", sorted(EDGES))
def test_host_build_equals_plain(host_lib, case, order):
    s, t, rows = EDGES[case]
    rng = np.random.default_rng(len(case) + 100 * order)
    mn, mx = (torch.from_numpy(p) for p in _planes(rng, 37, H))
    r = torch.tensor(rows + [-1, 37, 1 << 40], dtype=torch.int64)  # indices outside [0, V) are skipped
    mask = torch.zeros(37, dtype=torch.bool)
    mask[torch.tensor(rows, dtype=torch.int64)] = True
    pm, px = SP.span_update_planes_plain(mn, mx, mask, s, t)
    hm, hx = mn.clone(), mx.clone()
    host_lib.lt_host_warp_order(order)
    try:
        assert host_lib.lt_span_update(hm.data_ptr(), hx.data_ptr(), r.data_ptr(), r.numel(), 37, H, s, t, None) == 0
    finally:
        host_lib.lt_host_warp_order(0)
    assert torch.equal(hm, pm) and torch.equal(hx, px)


def test_wrapper_refuses_bad_operands():
    mn = torch.zeros((4, 8), dtype=torch.int32)
    rows = torch.tensor([0], dtype=torch.int64)
    with pytest.raises(TypeError):
        SP.span_update(mn, mn.clone(), rows.to(torch.int32), 0, 3)
    with pytest.raises(TypeError):
        SP.span_update(mn.to(torch.int64), mn.to(torch.int64), rows, 0, 3)
    with pytest.raises(ValueError):
        SP.span_update(mn, torch.zeros((4, 9), dtype=torch.int32), rows, 0, 3)
    with pytest.raises(ValueError):
        SP.span_update(mn, mn.clone(), rows, 0, 1 << 31)
    with pytest.raises(ValueError):
        SP.span_update(mn.t(), mn.clone().t(), rows, 0, 3)
    SP.reset_launches()
    SP.span_update(mn, mn.clone(), rows, 0, 3)
    assert SP.LAUNCHES["span_update"] == 0  # the plain version is no launch


# -- the span state ---------------------------------------------------------


@pytest.mark.parametrize("seed", [17, 29, 41])
def test_torch_span_state_equals_jax_and_numpy(seed):
    """Random apply / lookup / advance / growth sequences (after
    tests/test_slasher.py's model): the CPU TorchSpanState, JaxSpanState
    and the numpy SpanState agree exactly at every step."""
    import random as _random

    rng = _random.Random(seed)
    a = TSL.SpanState(num_validators=8, history_length=64, chunk_size=8)
    b = JSL.JaxSpanState(num_validators=8, history_length=64, chunk_size=8, use_export=False)
    c = TSL.TorchSpanState(num_validators=8, history_length=64, chunk_size=8, device="cpu")
    for step in range(40):
        t = rng.randint(0, 90)
        s = rng.randint(max(0, t - 30), t)
        rows = np.array(sorted(rng.sample(range(24 + step), rng.randint(1, 5))), np.intp)
        for sp in (a, b, c):
            sp.ensure_epoch(t)
            sp.ensure_validators(int(rows.max()) + 1)
            sp.apply(rows, s, t)
        assert a.base_epoch == b.base_epoch == c.base_epoch
        assert a.num_validators == b.num_validators == c.num_validators
        if s >= a.base_epoch:
            la, lb, lc = a.lookup(rows, s), b.lookup(rows, s), c.lookup(rows, s)
            for x, y, z in zip(la, lb, lc):
                assert isinstance(z, np.ndarray) and z.dtype == x.dtype == np.int32
                assert np.array_equal(x, np.asarray(y)) and np.array_equal(x, z)
        if step % 11 == 10:
            for sp in (a, b, c):
                sp.advance_base(sp.base_epoch + 16)
        if step == 33:  # a shift past the whole window resets both planes
            for sp in (a, b, c):
                sp.advance_base(sp.base_epoch + 64)
    snap_b, snap_c = b.snapshot(), c.snapshot()
    assert type(snap_c) is TSL.SpanState and snap_c.base_epoch == a.base_epoch
    for x, y, z in ((a.min_spans, snap_b.min_spans, snap_c.min_spans), (a.max_spans, snap_b.max_spans,
                                                                          snap_c.max_spans)):
        assert z.dtype == np.int32 and np.array_equal(x, y) and np.array_equal(x, z)


def test_torch_span_state_shift_in_row_chunks(monkeypatch):
    """The window shift copies through a bounded row-chunk temporary: a
    registry of several chunks (and a ragged last one) equals numpy's."""
    monkeypatch.setattr(TSL.device, "ADVANCE_ROWS", 3)
    rng = np.random.default_rng(5)
    a = TSL.SpanState(num_validators=11, history_length=32, chunk_size=4)
    c = TSL.TorchSpanState(num_validators=11, history_length=32, chunk_size=4, device="cpu")
    for _ in range(12):
        t = int(rng.integers(1, 31))
        s = int(rng.integers(-3, t + 1))
        rows = np.unique(rng.integers(0, 11, 4))
        a.apply(rows, s, t)
        c.apply(rows, s, t)
    for k in (4, 8, 20):
        a.advance_base(a.base_epoch + k)
        c.advance_base(c.base_epoch + k)
        snap = c.snapshot()
        assert np.array_equal(snap.min_spans, a.min_spans) and np.array_equal(snap.max_spans, a.max_spans)


def test_planes_assigned_from_numpy_move_on_first_use():
    """The service's warm start assigns the store's numpy planes; the
    state copies them onto its device at the next operation and never
    updates the caller's arrays."""
    src = TSL.SpanState(num_validators=6, history_length=16, chunk_size=4)
    src.apply(np.array([1, 4]), 2, 9)
    c = TSL.TorchSpanState(history_length=16, chunk_size=4, device="cpu")
    c.min_spans, c.max_spans = src.min_spans, src.max_spans
    keep = src.min_spans.copy(), src.max_spans.copy()
    c.apply(np.array([1, 2]), 3, 12)
    src.apply(np.array([1, 2]), 3, 12)
    assert isinstance(c.min_spans, torch.Tensor) and c.min_spans.device.type == "cpu"
    snap = c.snapshot()
    assert np.array_equal(snap.min_spans, src.min_spans) and np.array_equal(snap.max_spans, src.max_spans)
    # the arrays handed over were copied, not updated
    assert not np.array_equal(keep[0], src.min_spans)
    c2 = TSL.TorchSpanState(history_length=16, chunk_size=4, device="cpu")
    c2.min_spans, c2.max_spans = keep
    before = keep[0].copy()
    c2.apply(np.array([0]), 5, 10)
    assert np.array_equal(keep[0], before)
    with pytest.raises(IndexError):
        c2.apply(np.array([6]), 1, 2)
    with pytest.raises(IndexError):
        c2.lookup(np.array([-1]), 1)


def test_growth_is_geometric_and_keeps_the_rows():
    c = TSL.TorchSpanState(history_length=16, chunk_size=4, device="cpu")
    a = TSL.SpanState(history_length=16, chunk_size=4)
    for n in (1, 65, 66, 200, 201):
        for sp in (a, c):
            sp.ensure_validators(n)
            sp.apply(np.array([n - 1]), 1, 7)
        assert c.num_validators == a.num_validators
    snap = c.snapshot()
    assert np.array_equal(snap.min_spans, a.min_spans) and np.array_equal(snap.max_spans, a.max_spans)


# -- detectors ----------------------------------------------------------------


def _data(source, target, root=b"\x07" * 32, slot=0, index=0):
    return {
        "slot": slot,
        "index": index,
        "beacon_block_root": root,
        "source": {"epoch": source, "root": b"\x00" * 32},
        "target": {"epoch": target, "root": b"\x11" * 32},
    }


def _att(validators, source, target, root=b"\x07" * 32, slot=0, index=0):
    return {
        "attesting_indices": sorted(int(v) for v in validators),
        "data": _data(source, target, root=root, slot=slot, index=index),
        "signature": b"\x00" * 96,
    }


def _stream(seed, n_validators=64, n_epochs=48, n_atts=300):
    """Seeded attestations with a small root space, so double votes and
    surrounds occur, and a few protocol-invalid ones (target < source)."""
    rng = np.random.default_rng(seed)
    atts = []
    for _ in range(n_atts):
        t = int(rng.integers(1, n_epochs))
        s = int(rng.integers(0, t + 1)) if rng.random() > 0.02 else t + 1
        k = int(rng.integers(1, 4))
        vs = rng.choice(n_validators, size=k, replace=False)
        atts.append(_att(vs, s, t, root=bytes([int(rng.integers(0, 6))]) * 32))
    return atts


def _exact(dets):
    """Detections by kind and evidence object, in order."""
    return [(kind, id(sl["attestation_1"]), id(sl["attestation_2"])) for kind, sl in dets]


def _offender_pairs(dets):
    out = set()
    for kind, sl in dets:
        if kind in ("surround", "surrounded"):
            kind = "surround*"  # intra-batch group order can flip the side
        inter = set(int(i) for i in sl["attestation_1"]["attesting_indices"]) & set(
            int(i) for i in sl["attestation_2"]["attesting_indices"])
        out.update((kind, v) for v in inter)
    return out


def test_hashing_helpers_equal_jax():
    a, b = _data(0, 3, root=b"\x01" * 32), _data(0, 3, root=b"\x02" * 32)
    for x, y in ((a, b), (a, _data(0, 3, root=b"\x01" * 32)), (a, _data(0, 4)), (_data(0, 5), _data(1, 4)),
                 (_data(4, 6), _data(5, 5)), (_data(5, 5), _data(4, 6)), (_data(0, 2), _data(1, 2))):
        assert TSL.is_double_vote(x, y) == JSL.is_double_vote(x, y)
        assert TSL.is_surround_vote(x, y) == JSL.is_surround_vote(x, y)
    assert TT.AttestationData.hash_tree_root(a) == JT.AttestationData.hash_tree_root(a)


@pytest.mark.parametrize("batch_size", [1, 16])
def test_jax_attester_over_torch_spans_equals_jax_naive(batch_size):
    """The seam the JAX package offers: its AttesterSlasher with the
    port's span state assigned, against its own naive detector."""
    fast = JSL.AttesterSlasher(history_length=96, chunk_size=16)
    fast.spans = TSL.TorchSpanState(history_length=96, chunk_size=16, device="cpu")
    naive = JSL.NaiveAttesterSlasher()
    atts = _stream(11)
    total_fast, total_naive = set(), set()
    for i in range(0, len(atts), batch_size):
        total_fast |= _offender_pairs(fast.process_batch(atts[i : i + batch_size]))
        total_naive |= _offender_pairs(naive.process_batch(atts[i : i + batch_size]))
    assert total_fast and total_fast == total_naive


def _below_window(dets, base):
    """The detections whose NEW vote has its source below the window base
    `base`: the port probes those on the host, the JAX detector misses
    them (its new vote is attestation_1 of a surround, attestation_2 of a
    surrounded)."""
    def src(att):
        return int(att["data"]["source"]["epoch"])

    return [(k, sl) for k, sl in dets
            if (k == "surround" and src(sl["attestation_1"]) < base)
            or (k == "surrounded" and src(sl["attestation_2"]) < base)]


@pytest.mark.parametrize("batch_size", [1, 16, 64])
def test_port_attester_equals_jax_attester(batch_size):
    """The port's AttesterSlasher (CPU span planes and numpy) and its naive
    detector give the JAX ones' detections, evidence for evidence, with a
    prune midway (the window advances on both) — apart from the surrounds
    of votes whose source lies below the window, which the port finds on
    the host and the JAX detector misses; with those the port's offenders
    are its naive detector's."""
    atts = _stream(7 + batch_size)
    ports = [TSL.AttesterSlasher(history_length=64, chunk_size=16, device="cpu"),
             TSL.AttesterSlasher(history_length=64, chunk_size=16, span_backend="numpy")]
    jaxs = JSL.AttesterSlasher(history_length=64, chunk_size=16)
    naive_t, naive_j = TSL.NaiveAttesterSlasher(), JSL.NaiveAttesterSlasher()
    hits, extra = 0, 0
    offenders = [set() for _ in ports]
    naive_offenders = set()
    for i in range(0, len(atts), batch_size):
        if i >= len(atts) // 2 > i - batch_size:
            for d in ports + [jaxs, naive_t, naive_j]:
                d.prune(8)
        batch = atts[i : i + batch_size]
        base = jaxs.spans.base_epoch
        want = _exact(jaxs.process_batch(batch))
        for p, seen in zip(ports, offenders):
            got = p.process_batch(batch)
            below = _exact(_below_window(got, base))
            assert [d for d in _exact(got) if d not in below] == want
            extra += len(below)
            seen |= _offender_pairs(got)
        naive = naive_t.process_batch(batch)
        assert _exact(naive) == _exact(naive_j.process_batch(batch))
        naive_offenders |= _offender_pairs(naive)
        hits += len(want)
    assert hits and extra
    for p, seen in zip(ports, offenders):
        assert seen == naive_offenders
        assert p.record_count() == jaxs.record_count()
        assert (p.skipped_invalid, p.evidence_missing) == (jaxs.skipped_invalid, jaxs.evidence_missing)
        assert p.spans.base_epoch == jaxs.spans.base_epoch
    snap = ports[0].spans.snapshot()
    assert np.array_equal(snap.min_spans, jaxs.spans.min_spans) and np.array_equal(snap.max_spans,
                                                                                   jaxs.spans.max_spans)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_old_source_surround_of_a_record_in_the_window(backend):
    """A vote (10, 11), prune(10), then a vote (5, 12) by the same
    validator: the second surrounds the first, whose record is still in
    the window, while its own source lies below the window base.  The
    port probes the records on the host and reports it, as the naive
    detector does; the JAX detector misses it (its spans hold no column
    for a source below the base)."""
    kw = {"device": "cpu"} if backend == "torch" else {"span_backend": "numpy"}
    port, naive, jaxs = TSL.AttesterSlasher(history_length=16, chunk_size=4, **kw), TSL.NaiveAttesterSlasher(), \
        JSL.AttesterSlasher(history_length=16, chunk_size=4)
    first, second = _att([3], 10, 11, root=b"\x01" * 32), _att([3], 5, 12, root=b"\x02" * 32)
    for d in (port, naive, jaxs):
        assert d.process_batch([first]) == []
        d.prune(10)
    got, want = port.process_batch([second]), naive.process_batch([second])
    assert _exact(got) == [("surround", id(second), id(first))] == _exact(want)
    assert jaxs.process_batch([second]) == []  # the JAX side's miss, recorded, not fixed
    # the reverse: the old-source vote first, then a vote it surrounds
    port2 = TSL.AttesterSlasher(history_length=16, chunk_size=4, **kw)
    outer, inner = _att([4], 9, 14, root=b"\x03" * 32), _att([4], 11, 12, root=b"\x04" * 32)
    port2.prune(10)
    assert port2.process_batch([outer]) == []
    assert _exact(port2.process_batch([inner])) == [("surrounded", id(outer), id(inner))]


def test_old_source_attack_on_torch_spans():
    """tests/test_slasher.py's old-source case on the port: a source below
    the pruned window base still poisons the max spans."""
    s = TSL.AttesterSlasher(history_length=16, chunk_size=4, device="cpu")
    s.prune(8)
    assert s.process_batch([_att([1], 4, 20, root=b"\x01" * 32)]) == []
    dets = s.process_batch([_att([1], 9, 15, root=b"\x02" * 32)])
    assert [k for k, _ in dets] == ["surrounded"]
    assert int(dets[0][1]["attestation_1"]["data"]["source"]["epoch"]) == 4


def test_the_card_is_the_default(monkeypatch):
    """With no argument the span planes go to the card; without one that
    raises, and only an explicit request takes the CPU or numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSL.AttesterSlasher()
    with pytest.raises(RuntimeError, match="CUDA"):
        TSL.SlasherService()
    with pytest.raises(RuntimeError, match="CUDA"):
        TSL.TorchSpanState()
    assert isinstance(TSL.AttesterSlasher(span_backend="numpy").spans, TSL.SpanState)
    assert TSL.SlasherService(device="cpu").attester.spans.device.type == "cpu"
    with pytest.raises(ValueError):
        TSL.AttesterSlasher(span_backend="jax")
    with pytest.raises(ValueError):
        TSL.AttesterSlasher(span_backend="numpy", device="cpu")


# -- the service ----------------------------------------------------------------


class DictRepo:
    """A db repository over a dict, keys in order (the shape of the JAX
    package's db/repository.py that the store reads)."""

    def __init__(self):
        self.d = {}

    def put(self, key, value):
        self.d[bytes(key)] = value

    def get(self, key):
        return self.d.get(bytes(key))

    def has(self, key):
        return bytes(key) in self.d

    def delete(self, key):
        self.d.pop(bytes(key), None)

    def keys(self):
        return sorted(self.d)

    def entries(self):
        return sorted(self.d.items())


class DictDb:
    def __init__(self):
        self.slasher_min_span, self.slasher_max_span = DictRepo(), DictRepo()
        self.slasher_attestation, self.slasher_header = DictRepo(), DictRepo()

    def keys(self):
        return {name: getattr(self, name).keys() for name in
                ("slasher_min_span", "slasher_max_span", "slasher_attestation", "slasher_header")}


class StubChain:
    """The duck-typed chain the service calls: a dry-run that refuses
    slashings of listed offenders or slots, an op pool that records."""

    def __init__(self, types, refuse_offenders=(), refuse_slots=()):
        self.config = type("Cfg", (), {"get_fork_types": staticmethod(
            lambda slot: (None, None, types.BeaconBlockBodyAltair))})()
        self.refuse_offenders, self.refuse_slots = set(refuse_offenders), set(refuse_slots)
        self.inserted, self.covered, self.calls = [], set(), 0
        chain = self

        class Pool:
            def covered_attester_offenders(self):
                return set(chain.covered)

            def insert_attester_slashing(self, sl):
                chain.inserted.append(("attester", _offenders(sl)))
                chain.covered |= set(_offenders(sl))

            def insert_proposer_slashing(self, sl):
                h = sl["signed_header_1"]["message"]
                chain.inserted.append(("proposer", (int(h["slot"]), int(h["proposer_index"]))))

        self.op_pool = Pool()

    def validate_attester_slashing(self, sl):
        self.calls += 1
        if set(_offenders(sl)) & self.refuse_offenders:
            raise ValueError("refused")

    def on_attester_slashing(self, sl):
        pass

    def validate_proposer_slashing(self, sl):
        self.calls += 1
        if int(sl["signed_header_1"]["message"]["slot"]) in self.refuse_slots:
            raise ValueError("forged signature")


def _offenders(sl):
    return tuple(sorted(set(int(i) for i in sl["attestation_1"]["attesting_indices"])
                        & set(int(i) for i in sl["attestation_2"]["attesting_indices"])))


def _content(dets):
    """Detections by kind, offenders and the two votes' contents, in order
    (the two services read their evidence back as different objects)."""
    def vote(att):
        d = att["data"]
        return (tuple(int(i) for i in att["attesting_indices"]), int(d["source"]["epoch"]),
                int(d["target"]["epoch"]), bytes(d["beacon_block_root"]))

    return [(kind, _offenders(sl), vote(sl["attestation_1"]), vote(sl["attestation_2"])) for kind, sl in dets]


def _pool_walk(dets):
    """The op-pool inserts that `dets` give through a chain that refuses
    nothing: each detection is inserted unless every offender is covered."""
    covered, out = set(), []
    for _, sl in dets:
        off = _offenders(sl)
        if off and set(off) <= covered:
            continue
        out.append(("attester", off))
        covered |= set(off)
    return out


def _empty_altair_body(graffiti=b"\x00" * 32):
    return {
        "randao_reveal": b"\x00" * 96,
        "eth1_data": {"deposit_root": b"\x00" * 32, "deposit_count": 0, "block_hash": b"\x00" * 32},
        "graffiti": graffiti,
        "proposer_slashings": [],
        "attester_slashings": [],
        "attestations": [],
        "deposits": [],
        "voluntary_exits": [],
        "sync_aggregate": {
            "sync_committee_bits": [False] * TT.params.SYNC_COMMITTEE_SIZE,
            "sync_committee_signature": bytes([0xC0]) + b"\x00" * 95,
        },
    }


def _signed_block(slot, proposer, graffiti=b"\x00" * 32):
    return {
        "message": {"slot": slot, "proposer_index": proposer, "parent_root": b"\x00" * 32,
                    "state_root": b"\x00" * 32, "body": _empty_altair_body(graffiti)},
        "signature": b"\x00" * 96,
    }


def _services(chained, **kw):
    """(port service on CPU planes, JAX service) over their own dict dbs
    and stub chains."""
    out = []
    for mod, types, extra in ((TSL, TT, {"device": "cpu"}), (JSL, JT, {})):
        chain = StubChain(types, **kw) if chained else None
        db = DictDb()
        svc = mod.SlasherService(chain, db=db, history_length=64, chunk_size=8, max_batch=32, **extra)
        out.append((svc, chain, db))
    return out


def _status(svc):
    st = dict(svc.status())
    st.pop("last_flush_seconds")
    return st


@pytest.mark.parametrize("chained", [False, True])
def test_service_equals_jax_service(chained):
    """The same stream (attestations across epochs, clock ticks, a
    finalization, blocks with a double proposal, a far-future target)
    through both services: equal detections, rejections, op-pool inserts,
    store keys and status; then a restart of each over its db replays the
    evidence and re-detects alike."""
    pair = _services(chained, refuse_offenders={5, 9}, refuse_slots={70})
    atts = _stream(3, n_validators=32, n_epochs=20, n_atts=160)
    for svc, _, _ in pair:
        svc.start()
        for i, att in enumerate(atts):
            svc.ingest_attestation(att)
            if i % 40 == 39:
                svc.on_clock_slot(32 * int(att["data"]["target"]["epoch"]))
        svc.ingest_attestation(_att([1], 3, 500, root=b"\x09" * 32))  # past the clock's horizon
        svc.flush()
        svc.on_finalized(4)
        for slot, prop, g in ((40, 2, b"\x00"), (40, 2, b"\x01"), (41, 3, b"\x00"), (41, 3, b"\x00"), (70, 4, b"\x00"),
                              (70, 4, b"\x02"), (80, 5, b"\x00")):
            svc.ingest_block(_signed_block(slot, prop, g * 32), trusted=(slot == 80))
        svc.stop()
    (tsvc, tchain, tdb), (jsvc, jchain, jdb) = pair
    assert tsvc.detections == jsvc.detections
    assert sum(tsvc.detections.values()) > 3
    assert tsvc.rejected == jsvc.rejected
    assert (tsvc.skipped_future, tsvc.attestations_ingested, tsvc.blocks_ingested) == (
        jsvc.skipped_future, jsvc.attestations_ingested, jsvc.blocks_ingested)
    assert _status(tsvc) == _status(jsvc)
    assert tdb.keys() == jdb.keys()
    assert tdb.slasher_min_span.d == jdb.slasher_min_span.d and tdb.slasher_max_span.d == jdb.slasher_max_span.d
    if chained:
        assert tchain.inserted == jchain.inserted and tchain.calls == jchain.calls and tchain.inserted
    # restart: replay the evidence over the snapshot, on both; the replay
    # runs below the restored window base, where the port also finds the
    # surrounds of votes whose source lies below it (the JAX detector
    # misses those), so the port's detections are the JAX ones plus those,
    # in order, and its counts and op-pool inserts are what they give
    restarted, outs, below = [], [], []
    for (svc, chain, db), (mod, types, extra) in zip(pair, ((TSL, TT, {"device": "cpu"}), (JSL, JT, {}))):
        chain2 = StubChain(types) if chained else None
        svc2 = mod.SlasherService(chain2, db=db, history_length=64, chunk_size=8, **extra)
        out = []

        def process_batch(atts, batch=svc2.attester.process_batch, att=svc2.attester, out=out, port=mod is TSL):
            base = att.spans.base_epoch
            dets = batch(atts)
            out.extend(dets)
            if port:
                below.extend(_content(_below_window(dets, base)))
            return dets

        svc2.attester.process_batch = process_batch
        svc2.start()
        svc2.ingest_attestation(_att([7], 0, 19, root=b"\x0a" * 32))
        svc2.flush()
        restarted.append((svc2, chain2))
        outs.append(out)
    (t2, tc2), (j2, jc2) = restarted
    t_out, j_out = outs
    assert below and j_out
    rest = list(_content(t_out))
    for d in below:
        rest.remove(d)
    assert rest == _content(j_out)
    assert t2.detections == {kind: n + sum(k == kind for k, *_ in below) for kind, n in j2.detections.items()}
    assert t2.rejected == j2.rejected
    assert t2.attester.record_count() == j2.attester.record_count()
    assert t2.proposer.record_count() == j2.proposer.record_count()
    assert t2.attester.spans.base_epoch == j2.attester.spans.base_epoch
    assert isinstance(t2.attester.spans.min_spans, torch.Tensor)
    if chained:
        for chain, dets in ((tc2, t_out), (jc2, j_out)):
            assert [e for e in chain.inserted if e[0] == "attester"] == _pool_walk(dets)
            assert chain.calls == len(chain.inserted)
        assert [e for e in tc2.inserted if e[0] == "proposer"] == [e for e in jc2.inserted if e[0] == "proposer"]


def test_stop_takes_no_snapshot_without_a_persistent_store(monkeypatch):
    """A memory-only store saves nothing, so stop() copies no plane off the
    card; a persistent one gets the snapshot."""
    svc = TSL.SlasherService(device="cpu", history_length=64, chunk_size=8)
    svc.start()
    svc.ingest_attestation(_att([4], 1, 4))
    monkeypatch.setattr(TSL.TorchSpanState, "snapshot", lambda self: pytest.fail("snapshot taken"))
    svc.stop()
    assert not svc.running and svc.attestations_ingested == 1
    monkeypatch.undo()
    db = DictDb()
    svc = TSL.SlasherService(device="cpu", db=db, history_length=64, chunk_size=8)
    svc.start()
    svc.ingest_attestation(_att([4], 1, 4))
    svc.stop()
    spans = TSL.SlasherStore(db).load_spans()
    assert spans is not None and spans.num_validators == svc.attester.spans.num_validators


# the golden cases of tests/test_slasher.py, run on both packages
IMPLS = {"port": (TSL, TSVC, TT, {"device": "cpu"}), "jax": (JSL, JSVC, JT, {})}


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_golden_proposer_rejection_cap(impl):
    mod, svc_mod, _, extra = IMPLS[impl]

    class RejectingChain:
        config = None

        def __init__(self):
            self.calls = 0

        def validate_proposer_slashing(self, _sl):
            self.calls += 1
            raise ValueError("forged signature")

    chain = RejectingChain()
    svc = mod.SlasherService(chain, **extra)
    svc.ingest_block(_signed_block(3, 1), body_root=b"\x00" * 32)
    for i in range(1, 20):
        svc.ingest_block(_signed_block(3, 1), body_root=bytes([i]) + b"\x00" * 31)
    assert chain.calls == svc_mod.MAX_PROPOSER_REJECTIONS == 5
    assert svc.rejected == svc_mod.MAX_PROPOSER_REJECTIONS
    svc.ingest_block(_signed_block(4, 1), body_root=b"\x00" * 32)
    svc.ingest_block(_signed_block(4, 1), body_root=b"\x01" * 32)
    assert chain.calls == svc_mod.MAX_PROPOSER_REJECTIONS + 1


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_golden_equivocation_probe_gating(impl):
    mod, svc_mod, types, extra = IMPLS[impl]
    assert (svc_mod.MAX_EQUIVOCATION_ATTEMPTS, svc_mod.MAX_EQUIVOCATION_PROBE_FAILURES) == (4096, 3)
    svc = mod.SlasherService(chain=None, history_length=64, chunk_size=8, **extra)
    a = _att([7], 1, 4, root=b"\x01" * 32)
    root_a = bytes(types.AttestationData.hash_tree_root(a["data"]))
    b = _att([7], 1, 4, root=b"\x02" * 32)
    root_b = bytes(types.AttestationData.hash_tree_root(b["data"]))
    assert not svc.should_check_equivocation(7, 4, root_b)
    svc.ingest_attestation(a)
    assert svc.should_check_equivocation(7, 4, root_b)
    assert not svc.should_check_equivocation(7, 4, root_a)
    svc.flush()
    assert svc.should_check_equivocation(7, 4, root_b)
    for _ in range(svc_mod.MAX_EQUIVOCATION_PROBE_FAILURES - 1):
        svc.record_equivocation_probe([7], 4, root_b, ok=False)
        assert svc.should_check_equivocation(7, 4, root_b)
    svc.record_equivocation_probe([7], 4, root_b, ok=False)
    assert not svc.should_check_equivocation(7, 4, root_b)
    c = _att([7], 2, 4, root=b"\x03" * 32)
    root_c = bytes(types.AttestationData.hash_tree_root(c["data"]))
    assert svc.should_check_equivocation(7, 4, root_c)
    svc.record_equivocation_probe([7], 4, root_c, ok=True)
    assert not svc.should_check_equivocation(7, 4, root_c)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_golden_store_roundtrip_and_restart(impl):
    mod, _, _, extra = IMPLS[impl]
    db = DictDb()
    svc = mod.SlasherService(chain=None, db=db, history_length=64, chunk_size=8, **extra)
    svc.start()
    svc.ingest_attestation(_att([4], 1, 4, root=b"\x01" * 32))
    svc.flush()
    svc.stop()
    svc2 = mod.SlasherService(chain=None, db=db, history_length=64, chunk_size=8, **extra)
    svc2.start()
    assert svc2.attester.record_count() == 1 and svc2.attester.spans.num_validators >= 5
    svc2.ingest_attestation(_att([4], 0, 5, root=b"\x02" * 32))
    svc2.flush()
    assert svc2.detections["surround"] == 1
    svc2.ingest_block(_signed_block(9, 2))
    svc2.ingest_block(_signed_block(9, 2, graffiti=b"\x42" * 32))
    assert svc2.detections["double_propose"] == 1
    svc3 = mod.SlasherService(chain=None, db=db, history_length=64, chunk_size=8, **extra)
    svc3.start()
    assert svc3.detections["surround"] == 1 and svc3.detections["double_propose"] == 1
    assert svc3.proposer.record_count() == 1


def test_metrics_equal_jax():
    from lodestar_tpu.utils.metrics import Registry as JRegistry
    from lodestar_tpu_torch.utils.metrics import Registry as TRegistry

    regs = []
    for mod, reg, extra in ((TSL, TRegistry(), {"device": "cpu"}), (JSL, JRegistry(), {})):
        svc = mod.SlasherService(registry=reg, history_length=64, chunk_size=8, **extra)
        for att in _stream(9, n_validators=16, n_epochs=12, n_atts=40):
            svc.ingest_attestation(att)
        svc.flush()
        svc.ingest_block(_signed_block(3, 1))
        svc.ingest_block(_signed_block(3, 1, b"\x05" * 32))
        m = svc.metrics
        regs.append((m.attestations_ingested.value, m.blocks_ingested.value, m.queue_length.value,
                     m.validators_tracked.value, m.rejected_detections.value,
                     {k: m.detections.get(k) for k in ("double_vote", "surround", "surrounded", "double_propose")}))
    assert regs[0] == regs[1]
