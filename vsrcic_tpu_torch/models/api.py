"""High-level captioner facade: beam, greedy and sampled decodes, and
teacher forcing.

Counterpart of `vsrcic_tpu/models/api.py` (`ControllableCaptioner` with
`forward`, `test`, `sample_rl`, `beam_search_v` and `beam_search`). Strict
by default: f32 decodes with no hand-written kernel. The fast path is
opted into with the same switches as in JAX:

  * use_fused_attention: False | True (the fused gather + attention op:
    the CUDA kernel on the card, its plain version on the CPU) | "plain"
    (the plain version on any device);
  * use_vocab_topk: False | True (the vocab top-k + logsumexp op, likewise)
    | "plain" (the plain version on any device; JAX's "xla"). Without the
    fused op, on f32 parameters, the beam's candidate step then also runs
    its f32 products grouped by input through `ops/step_planes.py` (the
    kernels on the card, or, "plain", the plain version), which JAX leaves
    to XLA's dot. With True there, on f32 tables and on the card, the beam's
    steps run as CUDA graphs (`decode/graphs.py`): a decode shape's first
    batch as it is, its second captured, later ones replayed;
  * table_dtype: storage dtype of the statics tables and of the vocab op's
    out_fc table (torch.bfloat16 halves the bytes read per step). Unlike
    JAX's "xla" mode, "plain" reads the same cast table as the kernel, so
    the two differ only in the kernel;
  * decode_dtype: every parameter cast to it for `test`, `beam_search` and
    `beam_search_v` (`forward` and `sample_rl` keep the parameters as
    given), and the statics tables' dtype when table_dtype is None. The
    step then follows JAX's type promotion: a bf16 weight meets the f32
    state as an f32 product of its exact upcast, and only products of two
    bf16 operands (the groups' projection) stay bf16.

The environment variable VSRCIC_VOCAB_LHS_BF16=1 (JAX's knob, read where
JAX reads it: whenever a beam builds its vocab op, and only when
use_vocab_topk is True) rounds the vocab op's h2 to bf16; on a bf16 table
the card then runs the product on its tensor cores.

Entry points run on the CUDA card unless `device` names another; a missing
card raises.
"""
from __future__ import annotations

import os
import sys
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from vsrcic_tpu_torch.decode.beam import (BeamResult, beam_search_joint,
                                          beam_search_joint_candidates)
from vsrcic_tpu_torch.decode.graphs import StepGraphs, leaves
from vsrcic_tpu_torch.decode.loops import (forward_teacher_forcing,
                                           greedy_decode, sample_decode)
from vsrcic_tpu_torch.models.captioner import (
    STRICT, CaptionerConfig, GroupedProducts, LinearProducts, StepRoute,
    VerbTenseTable, _mm, captioner_step, captioner_step_v,
    captioner_step_v_topk, derive_fused_step_weights,
    derive_step_product_groups, image_descriptor_f32, init_captioner_params,
    init_state, precompute_statics)
from vsrcic_tpu_torch.ops.fused_attention import (
    fused_group_attention, fused_group_attention_plain)
from vsrcic_tpu_torch.ops.step_planes import (step_planes, step_planes_plain,
                                              step_weights)
from vsrcic_tpu_torch.ops.vocab_topk import (padded_table, split_bf16x3,
                                             table_planes, vocab_topk_lse,
                                             vocab_topk_lse_plain)
from vsrcic_tpu_torch.utils import observability as obs
from vsrcic_tpu_torch.utils.device import as_tensor, resolve_device, to_device
from vsrcic_tpu_torch.utils.params import flatten, unflatten

_MODES = (False, True, "plain")
# decode shapes whose step graphs a captioner keeps (the oldest go first)
GRAPH_SHAPES = 4


def _vocab_lhs_bf16():
    return os.environ.get("VSRCIC_VOCAB_LHS_BF16", "0") == "1"


def build_verb_tense_table(verb_2_vob_all: Dict[str, list],
                           n_verbs: Optional[int] = None,
                           device="cpu") -> VerbTenseTable:
    """{str(verb_code): [vocab ids]} (verb_2_vob_all_refine.json schema)
    -> dense (n_verbs+1, K) id table, -1 padded."""
    keys = [int(k) for k in verb_2_vob_all.keys()]
    n = max(keys + [n_verbs or 0]) + 1 if keys else (n_verbs or 1) + 1
    k_max = max([len(v) for v in verb_2_vob_all.values()] + [1])
    ids = np.full((n, k_max), -1, np.int64)
    for k, v in verb_2_vob_all.items():
        ids[int(k), :len(v)] = v
    return VerbTenseTable(torch.from_numpy(ids).to(device))


def step_route(params, cfg: CaptionerConfig, detections, det_groups,
               verb_list=None, *, use_fused_attention=False,
               use_vocab_topk=False, table_dtype=None, decode_dtype=None,
               candidates=False):
    """(statics, route, whether the steps replay as CUDA graphs) of a
    decode of `params`, which every decode passes in (a trainer decodes
    with its live parameters), under the facade's switches (the module's
    note), inside the span `beam.statics`. `candidates`: the decode is
    beam_search_v's. The route: with use_fused_attention the fused op on
    tables in table_dtype or decode_dtype, the first products fused; else,
    for the candidate step on f32 parameters, the grouped products (graphs
    with the kernels on f32 tables on the card); else the strict one."""
    with obs.span("beam.statics"):
        dt = table_dtype or decode_dtype

        def cast(a):
            return a.to(dt) if dt is not None and a.is_floating_point() else a
        detections = cast(detections)
        statics = precompute_statics(params, cfg, detections,
                                     cast(det_groups), verb_list=verb_list)
        # bf16 parameters keep jnp's promotion through nn.linear
        grouped = (candidates and bool(use_vocab_topk)
                   and not use_fused_attention
                   and all(v.dtype == torch.float32
                           for v in flatten(params).values()
                           if v.is_floating_point()))
        if not (use_fused_attention or grouped):
            return statics, STRICT, False
        fw = derive_fused_step_weights(params, cfg)
        # the image-descriptor slice of the input_1 projection is
        # step-invariant: computed once per decode, per item
        img_y = _mm(image_descriptor_f32(detections), fw["wx_img"]) + fw["bx"]
        if grouped:
            kernel = use_vocab_topk is True
            route = StepRoute(GroupedProducts(
                step_planes if kernel else step_planes_plain,
                {name: step_weights(w, b, with_planes=kernel) for name, (w, b)
                 in derive_step_product_groups(params, cfg, fw).items()}))
            graphs = (kernel and table_dtype in (None, torch.float32)
                      and detections.device.type == "cuda")
            return statics._replace(img_y=img_y), route, graphs
        tdt = dt or statics.det_groups.dtype
        statics = statics._replace(
            det_groups=statics.det_groups.to(tdt).contiguous(),
            det_groups_proj=statics.det_groups_proj.to(tdt).contiguous(),
            img_y=img_y)
        fused = (fused_group_attention if use_fused_attention is True
                 else fused_group_attention_plain)
        return statics, StepRoute(LinearProducts(fw), fused), False


class ControllableCaptioner:
    def __init__(self, cfg: CaptionerConfig, params=None, seed: int = 1234,
                 verb_2_vob_all: Optional[Dict] = None,
                 use_fused_attention=False, use_vocab_topk=False,
                 table_dtype=None, device=None, decode_dtype=None):
        """params: nested dict of tensors or arrays in torch layout (e.g.
        `utils.params.params_from_jax` of a JAX tree); made from `seed`
        when None. device: "cuda" unless given; "cpu" runs the plain
        versions of the kernels. decode_dtype: a torch dtype or None (see
        the module's note)."""
        if use_fused_attention not in _MODES or use_vocab_topk not in _MODES:
            raise ValueError("use_fused_attention / use_vocab_topk must be "
                             "one of False, True, 'plain'")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_captioner_params(
                torch.Generator().manual_seed(seed), cfg)
        self.params = to_device(params, self.device)
        self.use_fused_attention = use_fused_attention
        self.use_vocab_topk = use_vocab_topk
        self.table_dtype = table_dtype
        self.decode_dtype = decode_dtype
        self.decode_params = self.params if decode_dtype is None else \
            unflatten({k: v.to(decode_dtype) if v.is_floating_point() else v
                       for k, v in flatten(self.params).items()})
        self.tense_table = (build_verb_tense_table(verb_2_vob_all,
                                                   device=self.device)
                            if verb_2_vob_all is not None else None)
        self._vocab_tables = None
        self._w_planes = None
        self._finite_table = None
        self._step_graphs = {}

    # -- impls ---------------------------------------------------------------
    def _route(self, params, detections, det_groups, verb_list=None,
               candidates=False):
        """`step_route` of a decode of `params` under this captioner's
        switches."""
        return step_route(params, self.cfg, detections, det_groups, verb_list,
                          use_fused_attention=self.use_fused_attention,
                          use_vocab_topk=self.use_vocab_topk,
                          table_dtype=self.table_dtype,
                          decode_dtype=self.decode_dtype,
                          candidates=candidates)

    def _vocab_fn_and_tables(self, k):
        """The vocab op and its out_fc tables (w_t (R, V) in table_dtype or
        f32, bias (V,) f32), made from the decode params once per
        captioner, as JAX's `prepare_tables` pads its tables once: w_t is
        the [:, :V] view of a zero-filled buffer of pitch V rounded up to 8
        (`padded_table`, which TMA reads at any V). For the kernel's op,
        whether w_t is finite is read back once, with the tables, and a
        non-finite one's op passes `finite_table=False` on every call (the
        f32 SGEMM where h2 is f32, as ops/vocab_topk.py says; a finite
        table's op calls as before, the flag's default), and an f32 w_t's
        three bf16 planes (`table_planes`) are made once for the routes that
        read them. With use_vocab_topk True, VSRCIC_VOCAB_LHS_BF16=1 (read
        on every call, as JAX reads it on every trace) makes the op round h2
        to bf16 first, as JAX's `make_vocab_topk_lse(lhs_dtype=bfloat16)`
        does; "plain" ignores it, as JAX's "xla" path does."""
        if self._vocab_tables is None:
            out_fc = self.decode_params["out_fc"]
            w_t = padded_table(out_fc["weight"].T,
                               self.table_dtype or torch.float32)
            self._vocab_tables = (w_t, out_fc["bias"].float().contiguous())
            if self.use_vocab_topk is True:
                self._finite_table = bool(torch.isfinite(w_t).all())
                if not self._finite_table:
                    print("captioner: out_fc holds a non-finite weight; "
                          "the vocab head takes the f32 SGEMM on an f32 h2 "
                          "(slower than the split routes, exact on +-inf)",
                          file=sys.stderr)
        if self.use_vocab_topk is not True:
            return partial(vocab_topk_lse_plain, k=k), self._vocab_tables
        w_t = self._vocab_tables[0]
        lhs_bf16 = _vocab_lhs_bf16()
        finite = self._finite_table is not False
        kw = dict(k=k) if finite else dict(k=k, finite_table=False)
        if w_t.dtype == torch.float32 and (finite or lhs_bf16):
            if self._w_planes is None:
                self._w_planes = table_planes(w_t)
            kw["w_planes"] = self._w_planes
        op = partial(vocab_topk_lse, **kw)
        if lhs_bf16:
            return (lambda h2, w_t, b: op(h2.to(torch.bfloat16), w_t, b),
                    self._vocab_tables)
        return op, self._vocab_tables

    @torch.no_grad()
    def _greedy_impl(self, params, detections, det_groups):
        statics, route, _ = self._route(params, detections, det_groups)
        return greedy_decode(params, self.cfg, statics, route=route)

    @torch.no_grad()
    def _sample_impl(self, params, detections, det_groups, gen):
        statics, route, _ = self._route(params, detections, det_groups)
        return sample_decode(params, self.cfg, statics, gen, route=route)

    @torch.no_grad()
    def _beam_v_impl(self, params, detections, det_groups, verb_list,
                     beam_size, eos_word, gt):
        b = detections.shape[0]
        statics, route, graphs = self._route(params, detections, det_groups,
                                             verb_list, candidates=True)
        state = init_state(self.cfg, b * beam_size, device=self.device)
        if not self.use_vocab_topk:
            def step_fn(state, pw, pg, t0):
                return captioner_step_v(params, self.cfg, state, statics,
                                        self.tense_table, prev_word=pw,
                                        prev_gate=pg, t0=t0, gt=gt,
                                        beam=beam_size, route=route)

            return beam_search_joint(step_fn, state, b, beam_size,
                                     self.cfg.seq_len, eos_word=eos_word)
        vocab_fn, tables = self._vocab_fn_and_tables(beam_size)
        runner = None
        if graphs:
            runner = self._graphs_of(
                (statics, route, state), flatten(params), beam_size,
                eos_word, gt, route.kind, vocab_topk_lse, _vocab_lhs_bf16())
            statics, route, state = runner.fill((statics, route, state))

        def step_fn(state, pw, pg, t0):
            return captioner_step_v_topk(
                params, self.cfg, state, statics, self.tense_table,
                vocab_fn, tables, prev_word=pw, prev_gate=pg, t0=t0,
                gt=gt, beam=beam_size, k=beam_size, route=route)

        # the runner passed only where there is one: vsrbench's fault
        # checks put a loop of their own in the search's place
        res = beam_search_joint_candidates(
            step_fn, state, b, beam_size, self.cfg.seq_len,
            eos_word=eos_word, vocab_size=self.cfg.vocab_size,
            **({} if runner is None else dict(runner=runner)))
        # a replay's result lives in the graphs' pool
        return res if runner is None else BeamResult(
            *(x.clone() for x in res))

    def _graphs_of(self, inputs, flat_params, *key):
        """The `StepGraphs` of a decode: one per shape of its inputs, the
        parameters' tensors (a step reads some of them as they are) and
        `key` (the beam, EOS word, mode, the route's kind and the vocab op
        and its h2 rounding, as they are when called); made on the shape's
        first batch, at most GRAPH_SHAPES kept."""
        key += (tuple((x.shape, x.dtype) for x in leaves(inputs)),
                tuple(v.data_ptr() for v in flat_params.values()))
        graphs = self._step_graphs.get(key)
        if graphs is None:
            if len(self._step_graphs) >= GRAPH_SHAPES:
                del self._step_graphs[next(iter(self._step_graphs))]
            graphs = self._step_graphs[key] = StepGraphs(
                inputs, counted=(vocab_topk_lse, split_bf16x3, step_planes))
        return graphs

    @torch.no_grad()
    def _beam_impl(self, params, detections, det_groups, beam_size,
                   eos_word):
        b = detections.shape[0]
        statics, route, _ = self._route(params, detections, det_groups)

        def step_fn(state, pw, pg, t0):
            return captioner_step(params, self.cfg, state, statics,
                                  prev_word=pw, prev_gate=pg, t0=t0,
                                  beam=beam_size, route=route)

        return beam_search_joint(step_fn,
                                 init_state(self.cfg, b * beam_size,
                                            device=self.device),
                                 b, beam_size, self.cfg.seq_len,
                                 eos_word=eos_word)

    # -- public API (reference parity) ---------------------------------------
    def forward(self, detections, captions, ctrl_det_seqs):
        """Teacher-forced (word_logp (B, T, V), gate_logp (B, T, 2)) of
        captions (B, T) under groups ctrl_det_seqs (B, T, M, D)."""
        dev = self.device
        return forward_teacher_forcing(
            self.params, self.cfg, as_tensor(detections, dev),
            as_tensor(captions, dev, torch.long),
            as_tensor(ctrl_det_seqs, dev))

    def test(self, detections, ctrl_det_seqs_test):
        """Greedy decode: (words (B, T), gates (B, T))."""
        dev = self.device
        return self._greedy_impl(self.decode_params,
                                 as_tensor(detections, dev),
                                 as_tensor(ctrl_det_seqs_test, dev))

    def sample_rl(self, detections, ctrl_det_seqs_test, gen):
        """Sampled decode with per-step logprobs, drawn from `gen` (a
        torch.Generator on this captioner's device): ((words, gates),
        (word_logps, gate_logps)), each (B, T)."""
        dev = self.device
        return self._sample_impl(self.params, as_tensor(detections, dev),
                                 as_tensor(ctrl_det_seqs_test, dev), gen)

    def beam_search_v(self, detections, det_groups, verb_list, eos_word,
                      beam_size=5, gt=False) -> BeamResult:
        """Beam decode with verb substitution. detections (B, N, D),
        det_groups (B, L, M, D) (float32 or bfloat16, M padded or not),
        verb_list (B, L) verb ids or -1. Tensors or arrays."""
        dev = self.device
        return self._beam_v_impl(self.decode_params,
                                 as_tensor(detections, dev),
                                 as_tensor(det_groups, dev),
                                 as_tensor(verb_list, dev, torch.long),
                                 beam_size=beam_size, eos_word=eos_word,
                                 gt=gt)

    def beam_search(self, detections, det_groups, eos_word,
                    beam_size=5) -> BeamResult:
        """Beam decode without verb substitution (dense joint beam)."""
        dev = self.device
        return self._beam_impl(self.decode_params, as_tensor(detections, dev),
                               as_tensor(det_groups, dev),
                               beam_size=beam_size, eos_word=eos_word)
