"""The candidate beam's steps as CUDA graphs (`decode/graphs.py`).

On the CPU: the beam loop with a pass-through runner against the loop
without one, the runner's policy and counts with a stand-in graph, and the
facade's choice of route. On the card (marked `cuda`; skipped elsewhere;
they import neither JAX nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_beam_graphs.py
"""
from types import SimpleNamespace
from typing import NamedTuple

import pytest
import torch

import torch_parity as tp
from torch_parity import cuda_device  # noqa: F401  (fixture)
from vsrcic_tpu_torch.decode.beam import (BeamResult,
                                          beam_search_joint_candidates)
from vsrcic_tpu_torch.decode.graphs import StepGraphs, leaves
from vsrcic_tpu_torch.models import api
from vsrcic_tpu_torch.models.captioner import (captioner_step_v_topk,
                                               init_state)
from vsrcic_tpu_torch.ops import step_planes as sp
from vsrcic_tpu_torch.ops import vocab_topk as vt
from vsrcic_tpu_torch.utils import observability as obs
from vsrcic_tpu_torch.utils.params import flatten

K = 3


def captioner_case(seed=2):
    """The tiny captioner's candidate step on the products route (the
    plain versions on the CPU): (step_fn, state, batch, vocab size)."""
    cap = api.ControllableCaptioner(tp.torch_cfg(), seed=3,
                                    verb_2_vob_all=tp.VERB_TABLE,
                                    use_vocab_topk=True, device="cpu")
    det, groups, verb_list = (torch.as_tensor(x) for x in tp.inputs(seed))
    statics, route, _ = cap._route(cap.params, det, groups, verb_list,
                                   candidates=True)
    vocab_fn, tables = cap._vocab_fn_and_tables(K)

    def step_fn(state, pw, pg, t0):
        return captioner_step_v_topk(
            cap.params, cap.cfg, state, statics, cap.tense_table, vocab_fn,
            tables, prev_word=pw, prev_gate=pg, t0=t0, beam=K, k=K,
            route=route)
    b = det.shape[0]
    return step_fn, init_state(cap.cfg, b * K), b, cap.cfg.vocab_size


class Trail:
    """A state field that is no tensor: the rows' histories, which follow
    the beams through `__getitem__`."""

    def __init__(self, rows):
        self.rows = rows

    def __getitem__(self, idx):
        return Trail([self.rows[i] for i in idx.tolist()])


class ToyState(NamedTuple):
    h: torch.Tensor
    trail: Trail


def toy_case(seed=5, b=3, v=11):
    """A toy step over a state with a field that is no tensor."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((v, v), generator=g)

    def step_fn(state, pw, pg, t0):
        h = torch.tanh(state.h + w[pw] + pg[:, None])
        lp = torch.log_softmax(h, -1)
        wlp, ids = torch.topk(lp, K + 1, -1)
        g_logp = torch.log_softmax(h[:, :2], -1)
        trail = Trail([r + [int(p)] for r, p in zip(state.trail.rows,
                                                    pw.tolist())])
        return (ids, wlp, g_logp), ToyState(h, trail)
    state = ToyState(torch.randn((b * K, v), generator=g),
                     Trail([[] for _ in range(b * K)]))
    return step_fn, state, b, v


@pytest.mark.parametrize("case", [captioner_case, toy_case])
def test_pass_through_runner_matches_the_loop(case):
    """A runner that runs each body as it is gives the loop's result and
    final state, and is called once a step with the step's t."""
    step_fn, state, b, v = case()
    seq_len = 6
    want, want_state = beam_search_joint_candidates(
        step_fn, state, b, K, seq_len, eos_word=tp.EOS, vocab_size=v,
        with_state=True)
    steps = []

    def runner(t, body, carry):
        steps.append(t)
        return body(carry)
    got, got_state = beam_search_joint_candidates(
        step_fn, state, b, K, seq_len, eos_word=tp.EOS, vocab_size=v,
        with_state=True, runner=runner)
    assert steps == list(range(seq_len))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(leaves(got_state), leaves(want_state)):
        assert torch.equal(g, w)
    if isinstance(state, ToyState):
        assert got_state.trail.rows == want_state.trail.rows


class FakeGraph:
    """A stand-in for a CUDA graph: its capture runs fn (so its outputs
    hold values) and it counts its replays."""
    made = []

    def __init__(self):
        self.replays = 0
        FakeGraph.made.append(self)

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


def drive(graphs, inputs, steps=3):
    """One batch of `steps` chained steps through the runner; each body
    bumps the counters and a span count. Returns (result, bodies run)."""
    ran = []
    buf = graphs.fill(inputs)

    def body(t, carry):
        ran.append(t)
        graphs.counted[0].launches += 1
        graphs.counted[0].launches_split9 += 2
        obs.count("step_products", 5)
        return (carry[0] + 1,)
    carry = (buf[0],)
    for t in range(steps):
        with obs.span("beam.step"):
            carry = graphs(t, lambda c, t=t: body(t, c), carry)
    return carry, ran


def test_runner_policy_captures_on_a_shapes_second_batch():
    """Eager on a shape's first batch, each step captured on its second
    and replayed after; the inputs land in the same buffers each batch;
    a new shape captures its own graphs; without a card, always eager."""
    FakeGraph.made.clear()
    ctr = SimpleNamespace(launches=0, launches_split9=0, other=0)
    x = torch.zeros((4, 2))
    g = StepGraphs((x,), counted=(ctr,), graph=FakeGraph)
    caps, reps = StepGraphs.captures, StepGraphs.replays
    out1, ran1 = drive(g, (x + 10,))
    assert ran1 == [0, 1, 2] and not FakeGraph.made
    assert torch.equal(out1[0], x + 13)
    out2, ran2 = drive(g, (x + 20,))
    assert ran2 == [0, 1, 2] and len(FakeGraph.made) == 3
    assert [f.replays for f in FakeGraph.made] == [1, 1, 1]
    assert torch.equal(out2[0], x + 23)
    assert sorted(g.graphs) == [0, 1, 2]
    out3, ran3 = drive(g, (x + 30,))
    assert ran3 == [] and len(FakeGraph.made) == 3
    assert [f.replays for f in FakeGraph.made] == [2, 2, 2]
    assert out3[0] is out2[0]          # the captured outputs, replayed
    assert torch.equal(g.inputs[0], x + 30)
    assert StepGraphs.captures - caps == 3
    assert StepGraphs.replays - reps == 6
    # a new shape: its own buffers and graphs, captured on its second batch
    y = torch.zeros((2, 2))
    h = StepGraphs((y,), counted=(ctr,), graph=FakeGraph)
    assert drive(h, (y,))[1] == [0, 1, 2] and len(FakeGraph.made) == 3
    assert drive(h, (y,))[1] == [0, 1, 2] and len(FakeGraph.made) == 6
    assert drive(h, (y,))[1] == [] and h.graphs.keys() == g.graphs.keys()
    # no card, no stand-in: every batch runs every step as it is
    e = StepGraphs((x,), counted=(ctr,))
    for _ in range(3):
        assert drive(e, (x,))[1] == [0, 1, 2]
    assert not e.live and not e.graphs


def test_replays_add_the_captured_counts():
    """A replay adds to the launch counters and to the open span what its
    capture added, and counts itself; the summary sums them."""
    FakeGraph.made.clear()
    ctr = SimpleNamespace(launches=0, launches_split9=0, other=7)
    x = torch.zeros((4, 2))
    g = StepGraphs((x,), counted=(ctr,), graph=FakeGraph)
    for _ in range(2):
        drive(g, (x,))
    assert (ctr.launches, ctr.launches_split9, ctr.other) == (6, 12, 7)
    obs.clear()
    drive(g, (x,))
    assert (ctr.launches, ctr.launches_split9, ctr.other) == (9, 18, 7)
    summ = obs.summary()["beam.step"]
    assert summ["count"] == 3
    assert summ["counts"] == {"step_products": 15, "graph_replays": 3}
    assert "graph_replays 3" in obs.summary_line(obs.summary(), 1, "batch")
    with pytest.raises(RuntimeError, match="captured on"):
        g(1, lambda c: c, (torch.zeros((4, 2)),))


def test_open_counts_reads_the_innermost_span():
    obs.clear()
    assert obs.open_counts() == {}
    with obs.span("beam.step"):
        obs.count("a", 2)
        with obs.span("inner"):
            obs.count("b", 1)
            assert obs.open_counts() == {"b": 1}
        counts = obs.open_counts()
        counts["a"] = 99               # a copy
        assert obs.open_counts() == {"a": 2}


def test_facade_keeps_one_graph_set_a_shape():
    """The facade's graph sets: one per shape of the inputs (and per
    parameter tensors), the oldest dropped past GRAPH_SHAPES; on the CPU a
    beam makes none."""
    cap = api.ControllableCaptioner(tp.torch_cfg(), seed=3,
                                    verb_2_vob_all=tp.VERB_TABLE,
                                    use_vocab_topk=True, device="cpu")
    det, groups, verb_list = tp.inputs(2)
    cap.beam_search_v(det, groups, verb_list, eos_word=tp.EOS, beam_size=K)
    assert cap._step_graphs == {}
    flat = flatten(cap.params)

    def of(rows):
        return cap._graphs_of((torch.zeros((rows, 2)),), flat, K)
    a = of(4)
    assert of(4) is a and of(5) is not a
    of(6), of(7)
    assert len(cap._step_graphs) == 4
    of(8)
    assert len(cap._step_graphs) == 4 and of(4) is not a
    name = next(iter(flat))
    other = dict(flat, **{name: flat[name].clone()})
    assert cap._graphs_of((torch.zeros((8, 2)),), other, K) is not of(8)
    # the route's kind is part of the key
    assert (cap._graphs_of((torch.zeros((8, 2)),), flat, K, sp.step_planes)
            is not of(8))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def card_batches(device, rows):
    """Three batches of `rows` items: the parity inputs of three seeds."""
    out = []
    for seed in (2, 7, 11):
        det, groups, verb_list = tp.inputs(seed)
        out.append(tuple(torch.as_tensor(x[:rows]).to(device)
                         for x in (det, groups, verb_list)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [tp.B, tp.B - 1])
def test_graph_replays_equal_eager_bit_for_bit(cuda_device, rows):
    """The products route on the card, three batches of one shape: the
    first eager, the second captured, the third replayed. Each result
    equals a fresh captioner's eager one bit for bit; results stay as
    returned while later batches replay (no graph buffer aliased); the
    launch counters and span counts advance as in eager batches."""
    def make():
        return api.ControllableCaptioner(
            tp.torch_cfg(), seed=3, verb_2_vob_all=tp.VERB_TABLE,
            use_vocab_topk=True, device=cuda_device)
    cap = make()
    kept, snaps = [], []
    for i, (det, groups, verb_list) in enumerate(card_batches(cuda_device,
                                                              rows)):
        counts = (vt.vocab_topk_lse.launches, sp.step_planes.launches,
                  vt.split_bf16x3.launches, StepGraphs.captures,
                  StepGraphs.replays)
        obs.clear()
        got = cap.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                                beam_size=5)
        torch.cuda.synchronize()
        after = (vt.vocab_topk_lse.launches, sp.step_planes.launches,
                 vt.split_bf16x3.launches, StepGraphs.captures,
                 StepGraphs.replays)
        graphs = (tp.T, tp.T) if i == 1 else (0, tp.T) if i else (0, 0)
        # the split passes: one a step, and the table's planes once
        assert tuple(b - a for a, b in zip(counts, after)) == (
            tp.T, 5 * tp.T, tp.T + (i == 0)) + graphs
        step = obs.summary()["beam.step"]
        assert step["count"] == tp.T
        assert step["counts"]["step_products"] == 5 * tp.T
        assert step["counts"].get("graph_replays", 0) == graphs[1]
        want = make().beam_search_v(det, groups, verb_list,
                                    eos_word=tp.EOS, beam_size=5)
        for f, g, w in zip(BeamResult._fields, got, want):
            assert torch.equal(g, w), (i, f)
        kept.append(got)
        snaps.append(tuple(x.clone() for x in got))
    (sg,) = cap._step_graphs.values()
    assert sg.batches == 3 and sorted(sg.graphs) == list(range(tp.T))
    pool = {x.data_ptr() for _, _, out, _ in sg.graphs.values()
            for x in leaves(out)}
    for got, snap in zip(kept, snaps):
        assert not pool & {x.data_ptr() for x in got}
        for g, s in zip(got, snap):
            assert torch.equal(g, s)


@pytest.mark.cuda
def test_each_shape_captures_its_own_graphs(cuda_device):
    """Two shapes in turn on one captioner: each captures on its own
    second batch, and the replays of one do not disturb the other's."""
    cap = api.ControllableCaptioner(
        tp.torch_cfg(), seed=3, verb_2_vob_all=tp.VERB_TABLE,
        use_vocab_topk=True, device=cuda_device)
    shapes = {r: card_batches(cuda_device, r) for r in (tp.B, 2)}
    first = {}
    for i in range(3):
        for r, batches in shapes.items():
            caps = StepGraphs.captures
            res = cap.beam_search_v(*batches[i], eos_word=tp.EOS,
                                    beam_size=5)
            assert StepGraphs.captures - caps == (tp.T if i == 1 else 0)
            first.setdefault(r, (res, tuple(x.clone() for x in res)))
    assert len(cap._step_graphs) == 2
    for res, snap in first.values():
        for g, s in zip(res, snap):
            assert torch.equal(g, s)
