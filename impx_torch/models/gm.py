"""GM — the base graph matcher (impx/models/gm.py).

Keypoint encoding, the per-iteration final projection and scaled dot-product
distance, the score head (the log-domain optimal transport under
config.log_ot, else the non-log Sinkhorn, or the dual softmax when
config.with_sinkhorn is False) and mutual-NN matches; the layer-stepping
API (`init_state`, `_apply_layer`, `forward_one_layer`,
`forward_stacked_layer`) and the unrolled inference forward over it
(`produce_matches`, `run`), which takes N0 != N1; the reference's other
entry points (`produce_matches_test`, the module's `forward(data, mode,
training)`). The iterative loop (impx_torch/eval/iterative.py) steps the
layers through it. The unrolled training forward (`forward_train`) runs the
same layers under autograd with a supervised head after every cross layer;
under norm_fn='bn' its keypoint encoder normalises from each image's batch
statistics and its layers from the running statistics, as impx's
GM.forward_train does (impx/models/gm.py:186-194, :159-183).
DGNNS's stacked forwards are impx_torch/models/fast.py.

GM's dtype contract (impx/ops/attention.py:114-120): the stream stays fp32;
q, k and v are projected in fp32 and cast to the compute dtype for the
attention core.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from impx_torch.device import resolve_device
from impx_torch.geometry.keypoints import normalize_keypoints
from impx_torch.models.config import MatcherConfig
from impx_torch.models.gnn import MLP, AttentionalPropagation, Dense
from impx_torch.models.fast import _swap_half, supervised_head, train_outputs
from impx_torch.models.loss import loss_counts, maybe_epipolar_matrix
from impx_torch.ops.kernels.log_sinkhorn import log_optimal_transport_fused
from impx_torch.ops.matching import compute_matches as _compute_matches
from impx_torch.ops.sinkhorn import dual_softmax, sink_algorithm


class GM(nn.Module):
    """Base matcher with random weights drawn from `seed`; load trained or
    carried-across weights with `load_state_dict` (impx_torch/tools/convert.py).

    device: the CUDA device unless named; raises without one.
    use_kernels: False runs the plain PyTorch versions of the kernels on any
    device (the reference the kernels are held against). On CPU tensors the
    kernel wrappers run those plain versions anyway."""

    sharing = False
    # config.train_fused picks route B's attention core under autograd;
    # AdaGMN's trainer ignores it, as impx's does
    trains_fused = True

    def __init__(self, config: MatcherConfig, device: str | torch.device | None = None,
                 seed: int = 0, use_kernels: bool = True):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.compute_dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
        self.use_kernels = use_kernels
        # process groups, set by impx_torch/parallel (None: one device holds
        # the batch and the weights)
        self.data_group = None
        self.model_group = None
        self.seq_group = None       # sequence parallelism (parallel/mesh.py:set_seq_group)
        self.seq_union = None
        self.seq_size, self.seq_index = 1, 0
        d = config.descriptor_dim
        self.kenc = MLP([3, *config.keypoint_encoder, d], config.norm_fn)
        self.gnn = nn.ModuleList(
            AttentionalPropagation(d, config.num_heads, shared, config.norm_fn)
            for shared in config.sharing_layers(self.sharing))
        self.final_proj = nn.ModuleList(Dense(d, d) for _ in range(config.n_layers))
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(self.device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kenc.reset_parameters(generator)
        for layer in self.gnn:
            layer.reset_parameters(generator)
        for p in self.final_proj:
            p.reset_parameters(generator)
        self.bin_score.fill_(1.0)

    def _on_device(self, data: dict[str, Any]) -> dict[str, Any]:
        """Arrays and tensors of `data` moved to the model's device, floating
        point as fp32 (numpy's float64 included, as impx's jnp arrays are)."""
        out = {}
        for k, v in data.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                v = torch.as_tensor(v, device=self.device)
                if v.is_floating_point():
                    v = v.float()
            out[k] = v
        return out

    # ------------------------------------------------------ sequence parallelism
    def seq_rows(self, x):
        """This rank's block of axis 1 of x [B, N, ...] (all N keypoints of
        an image) under sequence parallelism; x itself otherwise. The
        validity masks arrive whole (impx_torch/parallel/tp.py:shard_batch_sp
        splits only the feature arrays): key masks and the score head take
        them as they are, the queries and the norms this block."""
        if self.seq_group is None:
            return x
        n = x.shape[1] // self.seq_size
        return x[:, self.seq_index * n:(self.seq_index + 1) * n]

    def whole_keypoints(self, data: dict) -> dict:
        """data with keypoints0/1 gathered over the sequence group (the
        epipolar loss reads every pair of keypoints); data itself without
        one."""
        if self.seq_group is None:
            return data
        from impx_torch.parallel.collectives import all_gather

        with torch.no_grad():
            return {**data, **{k: all_gather(data[k], self.seq_group, axis=1)
                               for k in ("keypoints0", "keypoints1") if k in data}}

    def _valid_masks(self, data, n0: int, n1: int):
        """valid0, valid1 over all keypoints (bool; all valid when absent),
        n0, n1 the local keypoint counts."""
        out = []
        for i, n in ((0, n0), (1, n1)):
            v = data.get(f"valid{i}")
            full = n * self.seq_size
            if v is None:
                v = torch.ones((data[f"descriptors{i}"].shape[0], full), dtype=torch.bool, device=self.device)
            elif v.shape[1] != full:
                raise ValueError(f"valid{i}: want all {full} keypoints of the image under sequence "
                                 f"parallelism (shard_batch_sp leaves the masks whole), got {tuple(v.shape)}")
            out.append(v.bool())
        return out

    # ------------------------------------------------------------- building blocks
    def encode_keypoint(self, norm_kpts, scores, valid=None, batch_stats: bool = False):
        """MLP over (x, y, score) -> [B, N, D] (impx/models/gm.py:58), one
        image's keypoints; batch_stats: batch norm from this image's valid
        keypoints over the batch (impx's train=True)."""
        x = torch.cat([norm_kpts, scores[..., None]], dim=-1)
        return self.kenc(x, ac_fn=self.config.ac_fn, mask=valid, batch_stats=batch_stats,
                         use_kernels=self.use_kernels)

    def _norm_kpts(self, data, which: int):
        key = f"norm_keypoints{which}"
        if key in data:
            return data[key]
        shape = data[f"image_shape{which}"]  # (..., H, W)
        return normalize_keypoints(data[f"keypoints{which}"], shape[-2], shape[-1])

    def compute_distance(self, desc0, desc1, layer_id: int = -1):
        """Final projection + scaled dot product (impx/models/gm.py:74)."""
        p = self.final_proj[layer_id]
        d0, d1 = p(desc0), p(desc1)
        if self.seq_group is not None:
            # the projection on this rank's rows, then every row of both
            # images: the head runs whole on every rank of the group, so the
            # gather's backward takes this rank's rows without summing
            from impx_torch.parallel.collectives import gather_for_replicated

            if d0.shape == d1.shape:
                d0, d1 = gather_for_replicated(torch.stack([d0, d1]), self.seq_group, axis=2).unbind(0)
            else:
                d0, d1 = (gather_for_replicated(d, self.seq_group, axis=1) for d in (d0, d1))
        dist = torch.einsum("bnd,bmd->bnm", d0, d1)
        return dist / (self.config.descriptor_dim ** 0.5)

    @property
    def scores_are_log(self) -> bool:
        """True when compute_score returns a log transport plan (the
        log-domain head; SuperGlue's always)."""
        return self.config.log_ot

    def compute_score(self, dist, valid0=None, valid1=None):
        """The score head with the learned dustbin, in impx's order
        (impx/models/gm.py:88-112): the log-domain head first, as impx's
        attn_impl='pallas' path runs it (u and v from the log-Sinkhorn kernel,
        its plain version when use_kernels is False, then the fp32 log plan);
        else the non-log Sinkhorn plan, or the dual softmax when
        config.with_sinkhorn is False."""
        bin_score = self.bin_score
        if self.seq_group is not None:  # every rank of the group runs the head: its gradient once
            from impx_torch.parallel.collectives import count_once

            bin_score = count_once(bin_score, self.seq_group)
        if self.scores_are_log:
            return log_optimal_transport_fused(dist, bin_score, self.config.sinkhorn_iterations,
                                               valid0, valid1, plain=not self.use_kernels)
        if not self.config.with_sinkhorn:
            return dual_softmax(dist, bin_score, valid0, valid1)
        plan_dtype = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
        return sink_algorithm(dist, bin_score, self.config.sinkhorn_iterations,
                              valid0, valid1, plan_dtype=plan_dtype)

    def compute_matches(self, scores, p=0.2, valid0=None, valid1=None):
        """Mutual-NN matches of a plan; a log plan is exponentiated first
        (impx/models/gm.py:114-117)."""
        if self.scores_are_log:
            scores = torch.exp(scores)
        return _compute_matches(scores, p=p, valid0=valid0, valid1=valid1)

    # ------------------------------------------------------------- layer stepping
    def init_state(self) -> dict[str, Any]:
        """The carried attention-sharing state (impx/models/gm.py:120): the
        (q, k) of the last layer of each kind, 'self' and 'cross', which a
        shared layer attends with (impx carries the probabilities, or these
        q/k on its fused path: the same values). Stacked [2B, H, N, dh]
        (image 0's queries, then image 1's) when both images have N
        keypoints, else a pair of per-image states."""
        return {"self": None, "cross": None}

    def _apply_layer(self, layer_i: int, x, source, qk=None, key_mask=None, query_mask=None,
                     with_lse: bool = False, batch_stats: bool = False):
        """One attentional-propagation layer (impx/models/gm.py:_apply_layer)
        under GM's dtype contract; returns (delta, (q, k)), and with_lse (the
        kernel path only) the row lse [B, H, N] fp32 of kernel 4 third.
        batch_stats: the MLP's batch norm from the batch's moments over the
        tokens of query_mask."""
        attn_dtype = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
        # under autograd config.train_fused picks route B's attention core
        # (kernels 4 and 5), as on the stacked training forward
        lse_core = self.trains_fused and self.config.train_fused and torch.is_grad_enabled()
        return self.gnn[layer_i](x, source, qk, key_mask, query_mask, ac_fn=self.config.ac_fn,
                                 use_kernels=self.use_kernels, attn_dtype=attn_dtype, lse_core=lse_core,
                                 with_lse=with_lse and self.use_kernels, batch_stats=batch_stats)

    def forward_stacked_layer(self, desc, layer_i: int, state, keep, keep_swap, query_mask,
                              with_lse: bool = False):
        """Layer layer_i on the stacked stream desc [2B, N, D] (image 0, then
        image 1): a self layer attends within the stack, a cross layer to the
        stack with its halves swapped, one launch for both images. keep
        [2B, N] holds the key masks of the queries' own images, keep_swap
        the other image's; query_mask the InstanceNorm mask. Returns (desc,
        state, lse or None)."""
        kind = "cross" if layer_i % 2 else "self"
        source, key_mask = (_swap_half(desc), keep_swap) if kind == "cross" else (desc, keep)
        delta, qk, *lse = self._apply_layer(layer_i, desc, source, state[kind], key_mask, query_mask,
                                            with_lse)
        return desc + delta, {**state, kind: qk}, (lse[0] if lse else None)

    def forward_one_layer(self, desc0, desc1, layer_i: int, state=None, valid0=None, valid1=None):
        """One self or cross layer on both images (impx/models/gm.py:159):
        stacked into one launch when N0 == N1, else one launch an image.
        valid0/valid1 [B, N0] / [B, N1] bool key and query masks (None: all
        valid). Returns (desc0, desc1, new_state)."""
        state = self.init_state() if state is None else state
        b, n0, n1 = desc0.shape[0], desc0.shape[1], desc1.shape[1]
        ones = lambda n: torch.ones((b, n * self.seq_size), dtype=torch.bool, device=desc0.device)  # noqa: E731
        valid0 = ones(n0) if valid0 is None else valid0
        valid1 = ones(n1) if valid1 is None else valid1
        desc0, desc1, state, _ = self._layer_pair(desc0, desc1, layer_i, state, valid0, valid1,
                                                  self.seq_rows(valid0), self.seq_rows(valid1))
        return desc0, desc1, state

    def _layer_pair(self, desc0, desc1, layer_i: int, state, key0, key1, query0, query1,
                    with_lse: bool = False, batch_stats: bool = False):
        """forward_one_layer's body with the attention keys under key0/key1
        and the queries' norm under query0/query1 (AdaGMN's masked loop keeps
        them apart). The images go through one stacked launch when N0 == N1
        and batch_stats is off; otherwise one launch an image, so that batch
        statistics never pool the two images (impx normalises each call's
        batch alone), and the state holds a (q, k) pair an image. Returns
        (desc0, desc1, state, lse): the stacked [2B, H, N] row lse of the
        layer's kernel 4 launch when with_lse on the kernel path and the
        images were stacked, else None."""
        b, n0, n1 = desc0.shape[0], desc0.shape[1], desc1.shape[1]
        if n0 == n1 and not batch_stats:
            desc, state, lse = self.forward_stacked_layer(
                torch.cat([desc0, desc1]), layer_i, state, torch.cat([key0, key1]), torch.cat([key1, key0]),
                torch.cat([query0, query1]), with_lse)
            return desc[:b], desc[b:], state, lse
        cross = layer_i % 2 == 1
        kind = "cross" if cross else "self"
        qk0, qk1 = state[kind] or (None, None)
        d0, qk0 = self._apply_layer(layer_i, desc0, desc1 if cross else desc0, qk0, key1 if cross else key0,
                                    query0, batch_stats=batch_stats)
        d1, qk1 = self._apply_layer(layer_i, desc1, desc0 if cross else desc1, qk1, key0 if cross else key1,
                                    query1, batch_stats=batch_stats)
        return desc0 + d0, desc1 + d1, {**state, kind: (qk0, qk1)}, None

    # ------------------------------------------------------------------ forwards
    def _encode_inputs(self, data, batch_stats: bool = False):
        """(desc0 [B, N0, D], desc1 [B, N1, D] fp32 with the keypoint encoding
        added, valid0, valid1 bool, all-valid when absent). batch_stats: the
        encoder's batch norm from each image's own batch (impx/models/gm.py:186)."""
        desc0, desc1 = data["descriptors0"], data["descriptors1"]
        valid = self._valid_masks(data, desc0.shape[1], desc1.shape[1])
        enc0 = self.encode_keypoint(self._norm_kpts(data, 0), data["scores0"], self.seq_rows(valid[0]), batch_stats)
        enc1 = self.encode_keypoint(self._norm_kpts(data, 1), data["scores1"], self.seq_rows(valid[1]), batch_stats)
        return desc0 + enc0, desc1 + enc1, valid[0], valid[1]

    @torch.no_grad()
    def produce_matches(self, data: dict[str, Any], p: float = 0.2, only_last: bool = False,
                        with_scores: bool = True):
        """The unrolled forward (impx/models/gm.py:196): every layer through
        `forward_one_layer`, then the score head after each cross layer (or
        the last). Takes N0 != N1. data: descriptors0/1 [B, N0/N1, D],
        norm_keypoints0/1 (or keypoints0/1 with image_shape0/1), scores0/1,
        optional valid0/1. Returns lists under 'scores' (fp32 [B, N0+1,
        N1+1] plans, None when with_scores=False), 'indices0', 'mscores0'."""
        desc0, desc1, valid0, valid1 = self._encode_inputs(self._on_device(data))
        state = self.init_state()
        out = {"scores": [], "indices0": [], "mscores0": []}
        for i in range(len(self.gnn)):
            desc0, desc1, state = self.forward_one_layer(desc0, desc1, i, state, valid0, valid1)
            if i % 2 == 0 or (only_last and i != len(self.gnn) - 1):
                continue
            score = self.compute_score(self.compute_distance(desc0, desc1, layer_id=i // 2), valid0, valid1)
            idx0, _, ms0, _ = self.compute_matches(score, p=p, valid0=valid0, valid1=valid1)
            out["scores"].append(score if with_scores else None)
            out["indices0"].append(idx0)
            out["mscores0"].append(ms0)
        return out

    def forward_train(self, data):
        """The unrolled training forward (impx/models/gm.py:223): every layer
        through `forward_one_layer` (stacked, one attention launch a layer,
        when N0 == N1; else one an image, Nq != Nk on the cross layers), and
        after each cross layer i the supervised head of final projection
        i // 2 (`supervised_head`: score head, graph_loss, geo_loss under
        with_geo); the terms are meaned over the iterations. data as
        `produce_matches`'s plus matching_mask [B, N0+1, N1+1] (and
        keypoints0/1, intrinsics0/1, gt_E for with_geo), moved to the model's
        device. Returns the dict of fast.py:train_outputs. Supervises every
        iteration: train_supervision='last' raises ValueError, as in impx.
        Under norm_fn='bn' the keypoint encoder normalises from batch
        statistics, one image at a time, and the layers from the running
        statistics, as impx's forward_one_layer calls them without train
        (impx/models/gm.py:168-181); the running statistics then take the
        layers' gradient."""
        cfg = self.config
        if cfg.train_supervision != "all":
            raise ValueError(f"train_supervision={cfg.train_supervision!r} needs the stacked training forward "
                             "(DGNNS with norm_fn='in' and the same keypoint count in both images)")
        data = self._on_device(data)
        desc0, desc1, valid0, valid1 = self._encode_inputs(data, batch_stats=True)
        gt = data["matching_mask"]
        counts = loss_counts(gt, self.data_group)
        epi = maybe_epipolar_matrix(self.whole_keypoints(data), cfg.geo_clamp) if cfg.with_geo else None
        state = self.init_state()
        terms, score = None, None
        for i in range(len(self.gnn)):
            desc0, desc1, state = self.forward_one_layer(desc0, desc1, i, state, valid0, valid1)
            if i % 2 == 1:
                t, score = supervised_head(self, desc0, desc1, i // 2, gt, epi, valid0, valid1, counts)
                terms = t if terms is None else {k: terms[k] + t[k] for k in terms}
        terms = {k: x / cfg.n_layers for k, x in terms.items()}
        return train_outputs(self, terms, score, gt, valid0, valid1, counts)

    def produce_matches_test(self, data: dict[str, Any], p: float = 0.2, only_last: bool = False, **kw):
        """The reference's alias of produce_matches (impx/models/gm.py:285)."""
        return self.produce_matches(data, p=p, only_last=only_last, **kw)

    def forward(self, data: dict[str, Any], mode: int = 0, training: bool = False):
        """The reference's dispatch (impx/models/gm.py:289, called as
        model(data, mode, training)): training -> forward_train, else mode 0
        -> produce_matches, any other mode -> run."""
        if training:
            return self.forward_train(data)
        if mode == 0:
            return self.produce_matches(data)
        return self.run(data)

    def run(self, data: dict[str, Any]):
        """SGMNet-style eval API (impx/models/gm.py:298): desc1/desc2, x1/x2 =
        (x, y, score) with normalized keypoints, optional valid0/1. Returns
        the last plan 'p' and the lists 'indices0', 'mscores0'."""
        feed = {"descriptors0": data["desc1"], "descriptors1": data["desc2"],
                "norm_keypoints0": data["x1"][..., :2], "norm_keypoints1": data["x2"][..., :2],
                "scores0": data["x1"][..., -1], "scores1": data["x2"][..., -1]}
        for k in ("valid0", "valid1"):
            if data.get(k) is not None:
                feed[k] = data[k]
        out = GM.produce_matches(self, feed, p=self.config.match_threshold, only_last=True)
        return {"p": out["scores"][-1], "indices0": out["indices0"], "mscores0": out["mscores0"]}
