"""The candidate step's f32 products grouped by input (`ops/step_planes.py`)
on the CPU.

On the card each group is one launch of `step_planes_kernel`: the three
exact bf16 planes of A and of W^T, nine plane products summed in f32. Here:
the plain version is the f32 product within f32 rounding (A in one, two and
three segments, K and N no multiples of 64); the planes sum back to A and W
exactly, so their nine products are the exact product; the step on
either fast products (grouped, or the fused route's first products) is
the strict `_step_core`'s function; `api.step_route` picks each route
from the facade's switches; the facade's candidate step calls the op five
times a step and no other decode or teacher forcing calls it; and the CPU
beam keeps JAX's words at the fast path's bar. The
kernels are held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py's step products phase)."""
import pytest
import torch

from vsrcic_tpu_torch.models import api
from vsrcic_tpu_torch.models.captioner import (
    CaptionerConfig, CaptionerState, GroupedProducts, LinearProducts,
    _per_row, _step_core, derive_fused_step_weights,
    derive_step_product_groups, image_descriptor_f32, init_captioner_params,
    precompute_statics)
from vsrcic_tpu_torch.ops import step_planes as sp
from vsrcic_tpu_torch.ops import vocab_topk as vt
from vsrcic_tpu_torch.utils import observability as obs

import torch_parity as tp

SEGMENTS = [(77,), (45, 19), (13, 100, 7), (8, 16, 24, 5)]


def _operands(seed, widths, n):
    g = torch.Generator().manual_seed(seed)
    segs = [torch.tanh(torch.randn((37, k), generator=g)) for k in widths]
    k = sum(widths)
    w = torch.randn((n, k), generator=g) * (2.0 / (n + k)) ** 0.5
    return segs, w, 0.1 * torch.randn((n,), generator=g)


@pytest.mark.parametrize("widths", SEGMENTS)
@pytest.mark.parametrize("n", [1, 129, 300])
@pytest.mark.parametrize("add_div", [None, 1, 5])
def test_plain_is_the_f32_product(widths, n, add_div):
    """Against the f64 product: within the f32 sums' rounding bound,
    K x 2^-24 x (|A| @ |W|^T + |b| + |add|)."""
    segs, w, b = _operands(len(widths) * 1000 + n, widths, n)
    add = None
    if add_div is not None:
        add = torch.randn((-(-37 // add_div), n),
                          generator=torch.Generator().manual_seed(n))
    sw = sp.step_weights(w, b)
    got = sp.step_planes_plain(segs, sw, add, add_div or 1)
    a = torch.cat(segs, 1).double()
    want = a @ w.double().T + b.double()
    scale = a.abs() @ w.double().abs().T + b.double().abs()
    if add is not None:
        rows = torch.arange(37) // add_div
        want = want + add.double()[rows]
        scale = scale + add.double().abs()[rows]
    assert got.dtype == torch.float32 and got.shape == (37, n)
    bound = (sum(widths) + 2) * 2.0 ** -24 * scale
    assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize("widths", SEGMENTS)
def test_planes_give_the_exact_product(widths):
    """A's planes (split_segments) and W^T's sum back to them bit for bit,
    so the nine plane products, each exact in f32, sum in f64 to the exact
    product: the kernel's products are the f32 product up to the order of
    its f32 sums."""
    segs, w, _ = _operands(7, widths, 129)
    k = sum(widths)
    a_planes = sp.split_segments(segs)
    assert a_planes.shape == (3, 37, k + -k % 8)
    assert torch.equal(a_planes, vt.split_bf16x3_plain(torch.cat(segs, 1)))
    w_planes = sp.split_segments([w.t().contiguous()])
    for planes, x in ((a_planes, torch.cat(segs, 1)), (w_planes, w.t())):
        assert bool((planes[:, :, x.shape[1]:] == 0).all())
        assert torch.equal(planes.double().sum(0)[:, :x.shape[1]],
                           x.double())
    nine = sum(a_planes[i].double()[:, :k] @ w_planes[j].double()[:, :129]
               for i in range(3) for j in range(3))
    torch.testing.assert_close(nine, torch.cat(segs, 1).double()
                               @ w.double().T, rtol=1e-15, atol=1e-15)


def test_wrapper_on_the_cpu_is_the_plain_version_and_counts():
    segs, w, b = _operands(3, (13, 100, 7), 129)
    sw = sp.step_weights(w, b)
    assert sw.planes is None and sw.w.dtype == torch.float32
    before = sp.step_planes.launches
    obs.clear()
    with obs.span("beam.step"):
        got = sp.step_planes(segs, sw)
        sp.step_planes(segs, sw)
    assert torch.equal(got, sp.step_planes_plain(segs, sw))
    assert obs.summary()["beam.step"]["counts"] == {"step_products": 2}
    assert sp.step_planes.launches == before   # no kernel on the CPU
    zero = sp.step_weights(w)
    assert torch.equal(zero.bias, torch.zeros(129))


@pytest.mark.parametrize("n,cluster", [(6000, 2), (4000, 2), (2560, 2),
                                       (1512, 2), (512, 2), (128, 1),
                                       (1, 1)])
def test_launch_plan_is_split9s(n, cluster):
    """The eval cell's groups at 2560 rows take the "split9" mainloop's
    plan: 128 x 128 tiles, SPLIT9_STAGES slots, clusters of 2 along N (one
    CTA where N is one tile), at most one CTA an SM."""
    plan = sp.step_launch_plan(2560, 3000, n, 132)
    ref = vt._tma_plan("split9", 2560, n, 132, vt.SPLIT9_STAGES, None, 3, 3)
    assert (plan.tile_m, plan.tile_n, plan.stages, plan.cluster, plan.grid,
            plan.smem_bytes, plan.planes, plan.w_planes) == (
        ref.tile_m, ref.tile_n, ref.stages, ref.cluster, ref.grid,
        ref.smem_bytes, ref.planes, ref.w_planes)
    assert plan.route == "step_planes" and plan.cluster == cluster
    assert plan.grid <= 132 and plan.grid % plan.cluster == 0
    tiles = 20 * -(-n // 128)
    assert plan.grid == min(132 // cluster, -(-tiles // cluster)) * cluster
    # the card's resident clusters of 2 cap the grid; clusters of one CTA
    # take one an SM
    assert sp.step_launch_plan(2560, 3000, n, 132, resident=7).grid == (
        14 if cluster == 2 else plan.grid)
    for bad in ((0, 3000, n), (2560, 0, n), (2560, 3000, 0)):
        with pytest.raises(ValueError):
            sp.step_launch_plan(*bad)


CFGS = {"h2_first": {}, "x_only": dict(h2_first_lstm=False),
        "img_second": dict(img_second_lstm=True)}


@pytest.mark.parametrize("products", ["grouped", "linear_fused"])
@pytest.mark.parametrize("cfg_kw", list(CFGS.values()), ids=list(CFGS))
def test_grouped_step_is_step_core(cfg_kw, products):
    """`_step_core` on either fast products gives the strict
    `_step_core`'s gate log-probs and states within f32 rounding, beam 3
    over 4 items: grouped (the plain op on the groups of
    derive_step_product_groups, img_y hoisted per item, five calls of the
    op) and linear with the fused first products (derive_fused_step_weights'
    two, img_y per row)."""
    cfg = CaptionerConfig(seq_len=5, vocab_size=30, det_feat_size=24,
                          input_encoding_size=12, rnn_size=16, att_size=8,
                          **cfg_kw)
    g = torch.Generator().manual_seed(5)
    params = init_captioner_params(g, cfg)
    for leaf in ("W1_is", "W1_hs", "W1_ig", "W1_hg", "s_fc", "lstm_cell_1",
                 "lstm_cell_2"):
        for name, t in params[leaf].items():
            if "bias" in name:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    beam, items = 3, 4
    rows = beam * items
    det = torch.rand((items, 6, 24), generator=g)
    statics = precompute_statics(params, cfg, det,
                                 torch.rand((items, 3, 5, 24), generator=g))
    fw = derive_fused_step_weights(params, cfg)
    img_y = image_descriptor_f32(det) @ fw["wx_img"].T + fw["bx"]
    pw = {n: sp.step_weights(w, b) for n, (w, b) in
          derive_step_product_groups(params, cfg, fw).items()}
    state = CaptionerState(*(torch.tanh(torch.randn((rows, 16), generator=g))
                             for _ in range(4)),
                           torch.zeros(rows, dtype=torch.long))
    it = torch.randint(0, 30, (rows,), generator=g)
    item = torch.arange(rows) // beam
    ctrl = torch.randint(0, 3, (rows,), generator=g)
    det_curr = statics.det_groups[item, ctrl]
    proj, mask = statics.det_groups_proj[item, ctrl], \
        statics.det_groups_mask[item, ctrl]
    image_descriptor, _ = _per_row(statics, beam, rows)
    calls = []

    def op(*a, **kw):
        calls.append(a[1].w.shape)
        return sp.step_planes_plain(*a, **kw)

    fast = (dict(products=GroupedProducts(op, pw), img_y=img_y, beam=beam)
            if products == "grouped" else
            dict(products=LinearProducts(fw), img_y=img_y[item]))
    (_, g_got), s_got = _step_core(params, cfg, state, it, det_curr, proj,
                                   mask, image_descriptor, word_head=False,
                                   **fast)
    (_, g_want), s_want = _step_core(params, cfg, state, it, det_curr, proj,
                                     mask, image_descriptor,
                                     word_head=False)
    assert len(calls) == (5 if products == "grouped" else 0)
    for got, want in zip((g_got,) + tuple(s_got), (g_want,) + tuple(s_want)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _tiny(use_vocab_topk, **kw):
    cfg = CaptionerConfig(seq_len=6, vocab_size=40, det_feat_size=24,
                          input_encoding_size=12, rnn_size=16, att_size=8)
    return api.ControllableCaptioner(
        cfg, seed=1, verb_2_vob_all={str(i): [5 + i, 20 + i]
                                     for i in range(1, 6)},
        use_vocab_topk=use_vocab_topk, device="cpu", **kw)


def _tiny_inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.randn((3, 7, 24), generator=g),
            torch.randn((3, 4, 5, 24), generator=g),
            torch.tensor([[-1, 2, -1, -1], [1, -1, -1, 3], [-1] * 4]))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("topk", api._MODES, ids=str)
@pytest.mark.parametrize("fused", api._MODES, ids=str)
def test_step_route_picks_the_route(fused, topk, bf16):
    """api.step_route: the fused op (its plain version with "plain") with
    the fused first products under use_fused_attention; else, for the
    candidate step under use_vocab_topk on f32 parameters, the grouped
    products (the wrapper with True, the plain op with "plain"); else the
    strict route; other decodes never group; no CUDA graphs off the card."""
    cap = _tiny(topk, use_fused_attention=fused,
                decode_dtype=torch.bfloat16 if bf16 else None)
    det, groups, verb_list = _tiny_inputs()
    for candidates in (False, True):
        statics, route, graphs = api.step_route(
            cap.decode_params, cap.cfg, det, groups, verb_list,
            use_fused_attention=fused, use_vocab_topk=topk,
            decode_dtype=cap.decode_dtype, candidates=candidates)
        assert graphs is False
        products, attention = route
        if fused:
            assert attention is (api.fused_group_attention if fused is True
                                 else api.fused_group_attention_plain)
            assert isinstance(products, LinearProducts)
            assert products.fused is not None and statics.img_y is not None
        elif candidates and topk and not bf16:
            assert attention is None and isinstance(products, GroupedProducts)
            assert products.op is (api.step_planes if topk is True
                                   else api.step_planes_plain)
            assert sorted(products.weights) == ["g", "h1", "in1", "lstm2", "s"]
            assert statics.img_y is not None
        else:
            assert route is api.STRICT and statics.img_y is None


@pytest.mark.parametrize("mode", [True, "plain"])
def test_candidate_step_calls_the_op_five_times_a_step(monkeypatch, mode):
    """use_vocab_topk without the fused op: every beam step (t = 0 too)
    makes the five grouped calls, on the wrapper (True: counted as
    `step_products` on `beam.step`) or the plain version ("plain"), whose
    weights carry no planes."""
    made, calls = [], {"step_planes": 0, "step_planes_plain": 0}
    for name in calls:
        def counted(*a, _f=getattr(api, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(api, name, counted)

    def weights(*a, _f=api.step_weights, **kw):
        made.append(kw["with_planes"])
        return _f(*a, **kw)
    monkeypatch.setattr(api, "step_weights", weights)
    cap = _tiny(mode)
    obs.clear()
    res = cap.beam_search_v(*_tiny_inputs(), eos_word=3, beam_size=3)
    summ = obs.summary()
    steps = summ["beam.step"]["count"]
    assert steps == cap.cfg.seq_len
    name = "step_planes" if mode is True else "step_planes_plain"
    assert calls[name] == 5 * steps and sum(calls.values()) == 5 * steps
    assert summ["beam.step"]["counts"] == (
        {"step_products": 5 * steps} if mode is True else {})
    assert made == [mode is True] * 5 and summ["beam.statics"]["count"] == 1
    assert res.words.shape == (3, 3, 6)


@pytest.mark.parametrize("path", ["strict_beam", "dense_beam", "fused",
                                  "decode_bf16", "greedy", "sample",
                                  "teacher_forcing"])
def test_other_paths_never_call_the_op(monkeypatch, path):
    """The strict step (captioner_step_v, captioner_step), the fused
    route's candidate step, bf16 parameters, decode/loops.py's greedy and
    sampled decodes and teacher forcing keep nn.linear: the op is never
    called and nothing is counted."""
    def refuse(*a, **kw):
        raise AssertionError("the step products' op was called")
    for name in ("step_planes", "step_planes_plain", "step_weights"):
        monkeypatch.setattr(api, name, refuse)
    det, groups, verb_list = _tiny_inputs()
    obs.clear()
    if path == "strict_beam":
        _tiny(False).beam_search_v(det, groups, verb_list, eos_word=3)
    elif path == "dense_beam":
        _tiny(True).beam_search(det, groups, eos_word=3, beam_size=3)
    elif path == "fused":
        _tiny(True, use_fused_attention=True).beam_search_v(
            det, groups, verb_list, eos_word=3)
    elif path == "decode_bf16":
        _tiny(True, decode_dtype=torch.bfloat16).beam_search_v(
            det, groups, verb_list, eos_word=3)
    elif path == "greedy":
        _tiny(True).test(det, groups)
    elif path == "sample":
        _tiny(True).sample_rl(det, groups, torch.Generator().manual_seed(0))
    else:
        caps = torch.randint(0, 40, (3, 6))
        _tiny(True).forward(det, caps, groups[:, :1].expand(-1, 6, -1, -1))
    counts = {k: v for e in obs.summary().values()
              for k, v in e["counts"].items()}
    assert "step_products" not in counts


@pytest.fixture(scope="module")
def jax_xla():
    """JAX's beam with its XLA vocab top-k and gathered attention (the f32
    products), compiled once for the module."""
    from vsrcic_tpu.models.api import ControllableCaptioner as JaxCaptioner
    params = tp.to_numpy_tree(tp.jax_params())
    return params, JaxCaptioner(tp.jax_cfg(), params=params,
                                verb_2_vob_all=tp.VERB_TABLE,
                                use_vocab_topk="xla")


@pytest.mark.parametrize("gt", [False, True])
@pytest.mark.parametrize("seed", [2, 7])
def test_products_beam_matches_jax(jax_xla, seed, gt):
    """The CPU beam through the grouped products (the plain op, img_y
    hoisted) keeps JAX's words and gates, scores and log-probs within the
    fast path's bar (rtol 1e-5, atol 1e-6)."""
    from vsrcic_tpu_torch.utils.params import params_from_jax
    params, jc = jax_xla
    tc = api.ControllableCaptioner(tp.torch_cfg(),
                                   params=params_from_jax(params, "cpu"),
                                   verb_2_vob_all=tp.VERB_TABLE,
                                   use_vocab_topk=True, device="cpu")
    det, groups, verb_list = tp.inputs(seed, gt)
    obs.clear()
    got = tc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                           beam_size=5, gt=gt)
    assert obs.summary()["beam.step"]["counts"]["step_products"] == 5 * tp.T
    want = jc.beam_search_v(det, groups, verb_list, eos_word=tp.EOS,
                            beam_size=5, gt=gt)
    tp.assert_beams_match(got, want)
