"""The program's spans and counters (impx_torch/tools/profiling.py): off,
a span is one shared no-op; on, the program dispatches the same operations
as off (a match call of IMP and of EIMP with compaction, a training step),
records the span tree its config implies (a span on another thread joins
the open call), counts every attention call's key mask and whether each
norm took the fused kernel, and stamps each span on the profiler's clock."""
import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from impx_torch.data.synthetic_device import synthesize_feed_device
from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
from impx_torch.models import gnn
from impx_torch.models.fast import _eimp_do_pool
from impx_torch.tools import profiling
from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

N_LAYERS = 6
SMALL = dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=N_LAYERS, num_heads=4, norm_fn="in",
             n_min_tokens=8)
COMPACTION = ((2, 48), (4, 32))


def _feed(n=64, b=2, n_valid=None):
    feed, _, _ = synthesize_feed_device(torch.Generator().manual_seed(0), b, n, 32, device="cpu")
    feed = {k: feed[k] for k in ("descriptors0", "descriptors1", "norm_keypoints0", "norm_keypoints1",
                                 "scores0", "scores1", "valid0", "valid1")}
    if n_valid is not None:
        feed["valid1"][:, n_valid:] = False
    return feed


def _train_batch(n=64, b=2):
    """The feed plus a matching mask: keypoint i of image 0 matches keypoint
    i of image 1 for the first quarter (synthesize's inliers), the rest go
    to the dustbins."""
    batch = _feed(n, b)
    gt = torch.zeros((b, n + 1, n + 1))
    inl = torch.arange(n // 4)
    gt[:, inl, inl] = 1.0
    gt[:, n // 4:n, n] = 1.0
    gt[:, n, n // 4:n] = 1.0
    batch["matching_mask"] = gt
    return batch


def _dgnns():
    return DGNNS(MatcherConfig(**SMALL), device="cpu", seed=0)


def _eimp():
    """EIMP with a dustbin score at which pooling drops keypoints."""
    model = AdaGMN(MatcherConfig(**SMALL, compaction=COMPACTION), device="cpu", seed=0)
    with torch.no_grad():
        model.bin_score.fill_(6.0)
    return model


def _match(model, n_valid=None):
    return lambda: model.produce_matches(_feed(n_valid=n_valid), only_last=True, with_scores=False)


def _train_step():
    model = _dgnns()
    step = make_train_step(model, TrainHyperParams())
    opt, stats, batch = init_opt_state(model), init_stats(torch.device("cpu")), _train_batch()
    return lambda: step(opt, 0, batch, stats)


CASES = {"dgnns": lambda: _match(_dgnns()), "eimp_compact": lambda: _match(_eimp()), "train_step": _train_step}


class _Ops(TorchDispatchMode):
    """The name of every operation dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _recorded(call):
    with profiling.recording() as rec:
        out = call()
    return rec, out


def test_tracing_off_is_a_shared_no_op():
    """Off, every span is the same no-op context and a counter keeps nothing;
    a recording turns both on for its body alone, one at a time."""
    assert profiling.span("impx.match") is profiling.span("impx.layer")
    with profiling.recording() as rec:
        with profiling.span("impx.match"):
            profiling.count("c", 1)
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    profiling.count("c", 2)
    assert profiling.span("impx.match") is profiling.span("impx.layer")
    assert [s.name for s in rec.spans] == ["impx.match"] and rec.counts == {"c": [(1,)]}


@pytest.mark.parametrize("case", list(CASES))
def test_tracing_dispatches_the_same_ops(case):
    """Tracing on, under a CPU profiler session that records the spans as
    ranges, dispatches the operations that tracing off does, in order."""
    off, on = _Ops(), _Ops()
    call_off, call_on = CASES[case](), CASES[case]()
    with off:
        call_off()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.recording() as rec, on:
            call_on()
    assert rec.spans and off.names
    assert [n for n in on.names if not n.startswith("profiler.")] == off.names


def test_a_span_on_another_thread_joins_the_open_call():
    """A span opened on another thread (autograd's, on the card) while a call
    is open takes the innermost span open on the call's thread as its parent
    and the call's root; its own children nest under it on its thread; once
    the call has closed, a span on any thread starts a call of its own."""
    import threading

    def worker():
        with profiling.span("impx.head.backward"):
            with profiling.span("impx.inner"):
                pass

    with profiling.recording() as rec:
        with profiling.span("impx.train.step"):
            with profiling.span("impx.train.backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
        assert not t.is_alive()
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    spans = rec.spans
    assert [(s.name, s.parent, s.root) for s in spans] == [
        ("impx.train.step", None, 0), ("impx.train.backward", 0, 0), ("impx.head.backward", 1, 0),
        ("impx.inner", 2, 0), ("impx.head.backward", None, 4), ("impx.inner", 4, 4)]
    assert spans[2].thread != spans[1].thread == spans[0].thread and spans[3].thread == spans[2].thread


def _children(rec, index):
    return [s.name for s in rec.spans if s.parent == index]


@pytest.mark.parametrize("case", list(CASES))
def test_span_tree(case):
    """One call: one impx.match holding one impx.encode, 2 * n_layers
    impx.layer each holding one impx.attn, a head on the last iteration
    (IMP) or on every one (EIMP), a pool on each pooling iteration and a
    gather and a scatter of the compaction (EIMP, only_last); every span
    shares the call's root. One step: impx.train.step holding its three
    phases, a supervised head each iteration, and in the backward the
    attention's and the heads' backward (on autograd's thread or this one)."""
    rec, _ = _recorded(CASES[case]())
    names = collections.Counter(s.name for s in rec.spans)
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in rec.spans)
    assert {s.root for s in rec.spans} == {0} and rec.spans[0].parent is None
    layers = [i for i, s in enumerate(rec.spans) if s.name == "impx.layer"]
    assert len(layers) == 2 * N_LAYERS and all(_children(rec, i) == ["impx.attn"] for i in layers)
    if case == "train_step":
        assert rec.spans[0].name == "impx.train.step"
        assert _children(rec, 0) == ["impx.train.forward", "impx.train.backward", "impx.train.optimizer"]
        backward = [i for i, s in enumerate(rec.spans) if s.name == "impx.train.backward"]
        below = collections.Counter(s.name for s in rec.spans if s.parent == backward[0])
        assert below == {"impx.head.backward": N_LAYERS, "impx.attn.backward": 2 * N_LAYERS}
        assert names == {"impx.train.step": 1, "impx.train.forward": 1, "impx.train.backward": 1,
                         "impx.train.optimizer": 1, "impx.encode": 1, "impx.layer": 2 * N_LAYERS,
                         "impx.attn": 2 * N_LAYERS, "impx.head": N_LAYERS, "impx.head.backward": N_LAYERS,
                         "impx.attn.backward": 2 * N_LAYERS}
        return
    assert rec.spans[0].name == "impx.match"
    kids = collections.Counter(_children(rec, 0))
    if case == "dgnns":
        assert kids == {"impx.encode": 1, "impx.layer": 2 * N_LAYERS, "impx.head": 1}
    else:
        pools = sum(_eimp_do_pool(MatcherConfig(**SMALL)))
        assert pools == 2
        assert kids == {"impx.encode": 1, "impx.layer": 2 * N_LAYERS, "impx.head": N_LAYERS,
                        "impx.pool": pools, "impx.compact": len(COMPACTION) + 1}
    assert sum(names.values()) == 1 + sum(kids.values()) + 2 * N_LAYERS


def test_key_counter_equals_the_masks(monkeypatch):
    """The counter's reduction equals the key masks that the attention
    wrappers receive, recounted from copies taken there, over an EIMP call
    whose padding, pools and gathers change them; with every keypoint valid,
    IMP keeps every slot."""
    seen = []

    def spy(fn):
        def wrapped(q, k, v, key_mask=None):
            seen.append((q.shape, k.shape[2], None if key_mask is None else key_mask.clone()))
            return fn(q, k, v, key_mask)
        return wrapped

    for name in ("mha_fused", "mha_fused_lse"):
        monkeypatch.setattr(gnn, name, spy(getattr(gnn, name)))
    rec, out = _recorded(_match(_eimp(), n_valid=56))
    kept = walked = 0
    for (b, h, nq, _), nk, mask in seen:
        walked += b * h * nq * nk
        kept += h * nq * (b * nk if mask is None else int(mask.sum()))
    assert len(seen) == 2 * N_LAYERS == len(rec.counts[profiling.KEYS])
    assert profiling.key_use(rec) == (kept, walked) and 0 < kept < walked
    assert bool((out["keep0"].sum(1) < 64).any()) and bool((out["keep1"].sum(1) < 56).any())

    rec, _ = _recorded(_match(_dgnns()))
    kept, walked = profiling.key_use(rec)
    assert kept == walked == 2 * N_LAYERS * 4 * 4 * 64 * 64


@pytest.mark.parametrize("case", list(CASES))
def test_norm_counter(case):
    """Counter NORMS over one call: every norm of a match call took the fused
    kernel's op (the keypoint encoder's two an image and one a layer), none of
    a training step's, whose forward runs under grad; the op is dispatched
    once a taken norm, with tracing on as off."""
    norms_a_call = 2 * 2 + 2 * N_LAYERS
    off, on = _Ops(), _Ops()
    call_off, call_on = CASES[case](), CASES[case]()
    with off:
        call_off()
    with profiling.recording() as rec, on:
        call_on()
    taken, norms = profiling.norm_use(rec)
    assert norms == norms_a_call and taken == (0 if case == "train_step" else norms_a_call)
    assert on.names == off.names and on.names.count("impx.norm_act.default") == taken


def test_span_clock_on_the_profiler_clock():
    """In a CPU profiler session each span is a user-annotated range, and its
    start converted to the session's clock lies within 50 us of the range's.
    The session's first range pays the profiler's set-up of the thread, so
    the second of two calls is compared; torch runs on one thread, whose
    idle workers would otherwise spin beside the spans."""
    model = DGNNS(MatcherConfig(**{**SMALL, "n_layers": 2}), device="cpu", seed=0)
    feed = _feed()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.recording() as rec:
                for _ in range(2):
                    model.produce_matches(feed, only_last=True, with_scores=False)
    finally:
        torch.set_num_threads(threads)
    spans = sorted(rec.on_profiler_clock(prof), key=lambda s: s[1])
    ranges = sorted((e for e in prof.events() if e.name.startswith("impx.")), key=lambda e: e.time_range.start)
    assert len(spans) == len(ranges) == 2 * (1 + 1 + 4 + 4 + 1)
    assert all(e.is_user_annotation for e in ranges)
    assert [s[0] for s in spans] == [e.name for e in ranges]
    second = [(s, e) for s, e in zip(spans, ranges) if s[5] != 0]
    assert len(second) == 11
    gaps = [abs(s[1] - e.time_range.start) for s, e in second]
    assert max(gaps) < 50.0, gaps
    assert all(s[1] <= e.time_range.start + 2.0 and e.time_range.end <= s[2] + 2.0 for s, e in zip(spans, ranges))
