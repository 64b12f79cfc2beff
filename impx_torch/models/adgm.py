"""AdaGMN — the EIMP matcher: DGNNS plus adaptive keypoint pooling
(impx/models/adgm.py).

Pooling is a masked computation: a bool keep mask per image shrinks on the
pooling iterations, and attention keys, the Sinkhorn head and the matches see
it. On a pooling iteration a keypoint survives if its row (column) mass in
the assignment plan reaches mscore_th, or if either of its attention masses
(summed over heads and queries, normalised) reaches the median of the
score-surviving set; an image never pools below n_min_tokens kept keypoints.
The masses come from the q/k states the layers carry and, on the kernel
path, each layer's row log-sum-exp, through the attention-mass kernel, so the
probabilities never reach device memory.

Routing follows impx's produce_matches (impx/models/adgm.py:246-269): the
stacked scans of impx/models/fast.py when norm_fn='in', not log_ot and both
images have the same keypoint count; otherwise the masked unrolled loop
`_iterate` (impx/models/adgm.py:167), which runs every layer under GM's dtype
contract, one launch an image when N0 != N1, and a score head on every
iteration. A compaction schedule on that loop runs mask-only, as impx's
default attn_impl does. Under log_ot the loop pools on the plan, exp of the
log plan, where impx pools on the log plan itself and so never pools
(ROADMAP section C).

Training (`forward_train`, impx/models/adgm.py:271) routes the same way: the
masked training scan, or the compacted one under config.train_compaction
(impx_torch/models/fast.py), for norm_fn='in', no log_ot and N0 == N1;
otherwise `_iterate` with the ground truth, where under norm_fn='bn' every
MLP, the keypoint encoder's included, normalises from batch statistics, one
image at a time, as impx's `_iterate(train=True)` does. Every iteration
takes a loss against the ground truth restricted to the kept keypoints
(`_masked_gt`) from first_it_to_update on; the accuracy is averaged over all
iterations. Under log_ot the loop's loss reads the log plan as a log plan
and its geometric loss and pooling take exp of it, where impx takes
log|log p| and never pools (ROADMAP section C). config.train_fused changes
nothing here, as in impx: every layer runs on route A.
"""
from __future__ import annotations

import torch

from impx_torch.models.dgnns import DGNNS
from impx_torch.models.fast import (
    EIMP_TRAIN_P, EIMP_TRAIN_TH, _eimp_do_pool, _mean_accuracy, forward_scan_eimp, forward_scan_eimp_compact,
    forward_train_scan_eimp, forward_train_scan_eimp_compact, loss_outputs, zero_terms)
from impx_torch.models.loss import geo_loss, graph_loss, loss_counts, matching_accuracy, maybe_epipolar_matrix
from impx_torch.ops.kernels.attention import attention_key_mass, attention_key_mass_reference
from impx_torch.tools.profiling import span


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median (torch.median semantics) of values[mask], per row of
    [B, N]; +inf for a row with an empty mask, so that no keypoint reaches it
    (impx/models/adgm.py:27)."""
    filled = torch.where(mask, values, torch.inf)
    sorted_vals = torch.sort(filled, dim=1).values
    k = ((mask.sum(dim=1) - 1) // 2).clamp(0, values.shape[1] - 1)
    return torch.gather(sorted_vals, 1, k[:, None])[:, 0]


def _normalise(mass: torch.Tensor) -> torch.Tensor:
    return mass / (mass.sum(dim=1, keepdim=True) + 1e-15)


def _key_attention_mass(prob: torch.Tensor, query_mask: torch.Tensor | None) -> torch.Tensor:
    """An attention probability tensor [B, H, Nq, Nk] summed over heads and
    the queries of query_mask [B, Nq] (all when None), per key, normalised
    to sum 1 (impx/models/adgm.py:40)."""
    if query_mask is None:
        mass = prob.sum(dim=(1, 2))
    else:
        mass = torch.einsum("bhqk,bq->bk", prob, query_mask.to(prob.dtype))
    return _normalise(mass)


def _masked_gt(gt, keep0, keep1):
    """The assignment mask [B, N+1, M+1] restricted to the kept keypoints
    keep0 [B, N], keep1 [B, M], with the dustbin row and column derived
    again: a kept keypoint whose partner was pooled away becomes unmatched
    (impx/models/adgm.py:325). fp32."""
    gtf = gt.float()
    k0, k1 = keep0.float(), keep1.float()
    inner = gtf[:, :-1, :-1] * k0[:, :, None] * k1[:, None, :]
    row_dust = k0 * (1.0 - inner.amax(dim=2))
    col_dust = k1 * (1.0 - inner.amax(dim=1))
    top = torch.cat([inner, row_dust[:, :, None]], dim=2)
    bottom = torch.cat([col_dust, torch.zeros_like(col_dust[:, :1])], dim=1)
    return torch.cat([top, bottom[:, None, :]], dim=1)


class AdaGMN(DGNNS):
    trains_fused = False  # impx's EIMP trainers have no route B

    def _key_masses(self, qk_self, qk_cross, keep0, keep1, qmask0, qmask1, lse_self=None,
                    lse_cross=None):
        """Normalised key masses (n00, n01, n11, n10) from the stacked q/k
        states [2B, H, N, dh], in two launches: the self state's keys are
        [image 0; image 1] under [keep0; keep1], the cross state's (source
        swapped) [image 1; image 0] under [keep1; keep0]; the queries that
        count are [qmask0; qmask1] in both (impx/models/fast.py:668-681).
        n01 has queries in image 1 and keys in image 0; n10 the reverse.
        lse_self, lse_cross [2B, H, N]: the row lse of the layers' attention
        over those keys, which the kernel path then does not recompute; the
        plain path computes the masses from q and k alone."""
        b = keep0.shape[0]
        qmask = torch.cat([qmask0, qmask1], dim=0)

        def mass(q, k, key_mask, lse):
            if not self.use_kernels:
                return attention_key_mass_reference(q, k, key_mask, qmask)
            return attention_key_mass(q, k, key_mask, qmask, lse)

        m_self = mass(*qk_self, torch.cat([keep0, keep1], dim=0), lse_self)
        m_cross = mass(*qk_cross, torch.cat([keep1, keep0], dim=0), lse_cross)
        # each rank summed its own heads (tensor parallelism) or its own
        # queries (sequence parallelism)
        group = self.model_group if self.model_group is not None else self.seq_group
        if group is not None:
            from impx_torch.parallel.collectives import psum

            m_self, m_cross = psum(torch.stack([m_self, m_cross]), group).unbind(0)
        return (_normalise(m_self[:b]), _normalise(m_cross[b:]),
                _normalise(m_self[b:]), _normalise(m_cross[:b]))

    def _masses_from_qk(self, s00, s01, s11, s10, keep0, keep1, qmask0=None, qmask1=None):
        """Normalised key masses from per-direction (q, k) states [B, H, N, dh]
        (impx/models/adgm.py:129): s00 queries 0 / keys 0, s01 queries 1 /
        keys 0, s11 queries 1 / keys 1, s10 queries 0 / keys 1. The query
        masks default to the keep masks. With the same N in both images the
        states stack into two launches, else each direction takes its own."""
        qmask0 = keep0 if qmask0 is None else qmask0
        qmask1 = keep1 if qmask1 is None else qmask1
        if keep0.shape[1] == keep1.shape[1]:
            stack = lambda a, c: tuple(torch.cat([x, y], dim=0) for x, y in zip(a, c))
            return self._key_masses(stack(s00, s11), stack(s10, s01), keep0, keep1, qmask0, qmask1)
        mass = attention_key_mass if self.use_kernels else attention_key_mass_reference
        masses = (mass(*s00, keep0, qmask0), mass(*s01, keep0, qmask1), mass(*s11, keep1, qmask1),
                  mass(*s10, keep1, qmask0))
        group = self.model_group if self.model_group is not None else self.seq_group
        if group is not None:  # each rank summed its own heads, or its own queries
            from impx_torch.parallel.collectives import psum

            masses = psum(torch.cat(masses, dim=1), group).split([m.shape[1] for m in masses], dim=1)
        return tuple(_normalise(m) for m in masses)

    def _pool_from_masses(self, rowmass, colmass, norm00, norm01, norm11, norm10,
                          keep0, keep1, th: float, n_min_tokens: int):
        """The pooling rule from the plan's interior row/column masses
        [B, N] / [B, M] and the normalised key masses; returns the new keep
        masks (impx/models/adgm.py:107)."""
        def side(keep, pids, norm_a, norm_b):
            aug = ((norm_a >= masked_median(norm_a, pids)[:, None])
                   | (norm_b >= masked_median(norm_b, pids)[:, None]))
            update = pids.any(dim=1, keepdim=True)
            if n_min_tokens > 0:
                update = update & (keep.sum(dim=1, keepdim=True) > n_min_tokens)
            return torch.where(update, keep & (pids | aug), keep)

        return (side(keep0, (rowmass >= th) & keep0, norm00, norm01),
                side(keep1, (colmass >= th) & keep1, norm11, norm10))

    def _pool_from_plan(self, plan, masses, keep0, keep1, th, n_min_tokens: int):
        """The pooling rule from a plan [B, N+1, M+1] (its interior's row and
        column masses) and the normalised key masses (impx/models/adgm.py:99)."""
        inner = plan[:, :-1, :-1]
        return self._pool_from_masses(inner.sum(dim=2), inner.sum(dim=1), *masses, keep0, keep1, th,
                                      n_min_tokens)

    def pool_masks(self, pred_score, s00, s01, s11, s10, keep0, keep1, mscore_th: float = 0.1,
                   uncertainty_ratio: float = 1.0, n_min_tokens: int | None = None,
                   qmask0=None, qmask1=None):
        """One pooling step from the plan pred_score [B, N+1, M+1]; returns
        (keep0, keep1) (impx/models/adgm.py:51). The four attention states
        are the (q, k) pairs of `_masses_from_qk`, or probability tensors
        [B, H, Nq, Nk] (s01 queries in image 1, keys in image 0; s10 the
        reverse), whose masses are summed directly. qmask0/qmask1: the
        queries that count in the mass sums (default: the keep masks).
        mscore_th: a float, or [B, 1] for a threshold a pair."""
        if n_min_tokens is None:
            n_min_tokens = self.config.n_min_tokens
        qmask0 = keep0 if qmask0 is None else qmask0
        qmask1 = keep1 if qmask1 is None else qmask1
        if isinstance(s00, torch.Tensor):
            masses = (_key_attention_mass(s00, qmask0), _key_attention_mass(s01, qmask1),
                      _key_attention_mass(s11, qmask1), _key_attention_mass(s10, qmask0))
        else:
            masses = self._masses_from_qk(s00, s01, s11, s10, keep0, keep1, qmask0, qmask1)
        return self._pool_from_plan(pred_score, masses, keep0, keep1, mscore_th * uncertainty_ratio,
                                    n_min_tokens)

    def pool(self, pred_score, prob00, prob01, prob11, prob10, mscore_th: float = 0.1,
             uncertainty_ratio: float = 1.0, n_min_tokens: int = 256, keep0=None, keep1=None):
        """Stand-alone pooling of the reference's API (impx/models/adgm.py:154):
        `pool_masks` with every keypoint kept unless keep0/keep1 say
        otherwise."""
        b, n0p, n1p = pred_score.shape
        ones = lambda n: torch.ones((b, n), dtype=torch.bool, device=pred_score.device)  # noqa: E731
        keep0 = ones(n0p - 1) if keep0 is None else keep0
        keep1 = ones(n1p - 1) if keep1 is None else keep1
        return self.pool_masks(pred_score, prob00, prob01, prob11, prob10, keep0, keep1, mscore_th,
                               uncertainty_ratio, n_min_tokens)

    def pool_masks_stacked(self, pred_score, qk_self, qk_cross, keep0, keep1, mscore_th,
                           lse_self=None, lse_cross=None, n_min_tokens: int | None = None):
        """`pool_masks` from the stacked states that GM.forward_stacked_layer
        carries (qk_self, qk_cross [2B, H, N, dh]), the queries that count
        being the keep masks, as in impx's iterative loop
        (impx/eval/iterative.py:193, :442). mscore_th: a float, or [B, 1] for
        a threshold a pair. lse_self, lse_cross [2B, H, N]: the row lse of
        those layers (kernel 4) on the kernel path, which the mass kernel
        then takes in one pass."""
        if n_min_tokens is None:
            n_min_tokens = self.config.n_min_tokens
        masses = self._key_masses(qk_self, qk_cross, keep0, keep1, keep0, keep1, lse_self, lse_cross)
        return self._pool_from_plan(pred_score, masses, keep0, keep1, mscore_th, n_min_tokens)

    def _on_scan(self, data) -> bool:
        """Whether the stacked scans take data (already on the device):
        norm_fn='in', no log_ot and N0 == N1 (impx/models/adgm.py:253, :285)."""
        cfg = self.config
        return (cfg.norm_fn == "in" and not cfg.log_ot
                and data["descriptors0"].shape[1] == data["descriptors1"].shape[1])

    def _iterate(self, data, p: float, mscore_th: float, uncertainty_ratio: float, with_scores: bool = True,
                 gt=None):
        """The masked unrolled loop (impx/models/adgm.py:167), on data already
        on the model's device. Every layer through GM's layer API (stacked
        when N0 == N1, one launch an image otherwise): attention keys under
        the keep masks, queries and the norm under the padding validity
        full0/full1. After each iteration the score head under the keep masks
        and its matches; on the pooling iterations the key masses summed over
        full queries and the pooling rule on the plan (exp of the log plan
        under log_ot). At inference on the kernel path with N0 == N1 a
        pooling iteration's layers run kernel 4, whose row lse the masses
        take, as `_eimp_step` does; at N0 != N1 the masses take one launch a
        direction, stacked into two when N0 == N1.

        gt [B, N0+1, N1+1] (training, impx's train=True): under autograd,
        each iteration adds graph_loss against gt, restricted to the kept
        keypoints from first_it_to_update on (`_masked_gt`), and under
        with_geo the geometric loss of the plan; under norm_fn='bn' every MLP
        normalises from batch statistics, one image at a time; the masses
        come from kernel 6's standalone route and pooling runs without
        gradient. Returns (scores, indices0, mscores0 per iteration,
        (keep0, keep1), the summed terms or None); scores holds None without
        with_scores."""
        cfg = self.config
        train = gt is not None
        batch_stats = train and cfg.norm_fn == "bn"
        desc0, desc1, full0, full1 = self._encode_inputs(data, batch_stats=train)
        keep0, keep1 = full0, full1
        full0, full1 = self.seq_rows(full0), self.seq_rows(full1)   # the queries (this rank's block)
        split = batch_stats or desc0.shape[1] != desc1.shape[1]
        th = mscore_th * uncertainty_ratio
        epi = (maybe_epipolar_matrix(self.whole_keypoints(data), cfg.geo_clamp) if train and cfg.with_geo
               else None)
        terms = zero_terms(epi is not None, desc0.device) if train else None
        counts = loss_counts(gt, self.data_group) if train else None
        state = self.init_state()
        scores, all_idx0, all_ms0 = [], [], []
        for ni, do_pool in enumerate(_eimp_do_pool(cfg)):
            with_lse = do_pool and self.use_kernels and not train
            desc0, desc1, state, lse_self = self._layer_pair(desc0, desc1, 2 * ni, state, keep0, keep1,
                                                             full0, full1, with_lse, batch_stats)
            desc0, desc1, state, lse_cross = self._layer_pair(desc0, desc1, 2 * ni + 1, state, keep0, keep1,
                                                              full0, full1, with_lse, batch_stats)
            score = self.compute_score(self.compute_distance(desc0, desc1, layer_id=ni), keep0, keep1)
            if train:
                gt_used, c = gt, counts
                if ni >= cfg.first_it_to_update:
                    gt_used = _masked_gt(gt, keep0, keep1)
                    c = loss_counts(gt_used, self.data_group)
                t = graph_loss(score, gt_used, scores_are_log=self.scores_are_log, counts=c)
                if epi is not None:
                    t["geo"] = geo_loss(torch.exp(score) if self.scores_are_log else score, epi, keep0, keep1,
                                        n_pairs=None if c is None else c[0])
                terms = {k: terms[k] + t[k] for k in terms}
            with torch.no_grad():
                idx0, _, ms0, _ = self.compute_matches(score, p=p, valid0=keep0, valid1=keep1)
                all_idx0.append(idx0)
                all_ms0.append(ms0)
                scores.append(score if with_scores else None)
                if not do_pool:
                    continue
                if split:
                    (s00, s11), (s10, s01) = state["self"], state["cross"]
                    masses = self._masses_from_qk(s00, s01, s11, s10, keep0, keep1, full0, full1)
                else:
                    masses = self._key_masses(state["self"], state["cross"], keep0, keep1, full0, full1,
                                              lse_self, lse_cross)
                plan = torch.exp(score) if self.scores_are_log else score
                keep0, keep1 = self._pool_from_plan(plan, masses, keep0, keep1, th, cfg.n_min_tokens)
        return scores, all_idx0, all_ms0, (keep0, keep1), terms

    @torch.no_grad()
    def produce_matches(self, data, p: float = 0.2, mscore_th: float = 0.1,
                        uncertainty_ratio: float = 1.0, only_last: bool = False,
                        with_scores: bool = True):
        """Matches for a batch of pairs with EIMP pooling
        (impx/models/adgm.py:246); inputs as DGNNS.produce_matches. With
        norm_fn='in', no log_ot and equal keypoint counts: forward_scan_eimp_compact
        when config.compaction is set, else forward_scan_eimp. Otherwise the
        masked loop `_iterate` (mask-only, whatever config.compaction says),
        whose 'scores' is the last iteration's plan whatever only_last says.
        Adds 'keep0'/'keep1' [B, N] bool (the keypoints that survived
        pooling) and, compacted, 'overflow0'/'overflow1' [B] (survivors
        dropped because a bucket was full: re-run those pairs with
        compaction=())."""
        with span("impx.match"):
            data = self._on_device(data)
            cfg = self.config
            if not self._on_scan(data):
                scores, idx0, ms0, (keep0, keep1), _ = self._iterate(data, p, mscore_th, uncertainty_ratio,
                                                                     with_scores)
                if only_last:
                    idx0, ms0 = idx0[-1:], ms0[-1:]
                return {"scores": scores[-1:], "indices0": idx0, "mscores0": ms0, "keep0": keep0, "keep1": keep1}
            kw = dict(p=p, mscore_th=mscore_th, uncertainty_ratio=uncertainty_ratio,
                      only_last=only_last)
            if cfg.compaction and self.seq_group is None:  # sequence parallelism runs mask-only
                return forward_scan_eimp_compact(self, data, **kw)
            return forward_scan_eimp(self, data, with_scores=with_scores, **kw)

    def forward_train(self, data):
        """EIMP training (impx/models/adgm.py:271): `produce_matches`'s data
        plus matching_mask [B, N0+1, N1+1] (and keypoints0/1, intrinsics0/1,
        gt_E for with_geo), moved to the model's device. Differentiable;
        returns the dict of impx_torch/models/fast.py:train_outputs, whose
        accuracy counters are averaged over all iterations and whose matches0
        and matching_scores0 are the last iteration's (p = 0.2). With
        norm_fn='in', no log_ot and N0 == N1 the stacked training scan, the
        compacted one when config.train_compaction is set (which adds
        compaction_overflow0/1); otherwise the unrolled `_iterate`, where a
        train_compaction schedule raises ValueError, as in impx.
        train_supervision='last' raises ValueError: pooling needs every
        iteration's plan."""
        cfg = self.config
        if cfg.train_supervision != "all":
            raise ValueError("train_supervision='last' is not defined for the EIMP trainer (pooling decisions "
                             "depend on per-iteration scores)")
        data = self._on_device(data)
        if self._on_scan(data):
            if cfg.train_compaction and self.seq_group is None:  # sequence parallelism: the masked scan
                return forward_train_scan_eimp_compact(self, data)
            return forward_train_scan_eimp(self, data)
        if cfg.train_compaction:
            raise ValueError("config.train_compaction needs the training scan: norm_fn='in', log_ot=False and "
                             f"the same keypoint count in both images (got norm_fn={cfg.norm_fn!r}, "
                             f"log_ot={cfg.log_ot}, N0={data['descriptors0'].shape[1]}, "
                             f"N1={data['descriptors1'].shape[1]})")
        gt = data["matching_mask"]
        _, all_idx0, all_ms0, _, terms = self._iterate(data, EIMP_TRAIN_P, EIMP_TRAIN_TH, 1.0,
                                                       with_scores=False, gt=gt)
        terms = {k: x / cfg.n_layers for k, x in terms.items()}
        n_pairs = None if self.data_group is None else loss_counts(gt, self.data_group)[0]
        acc = _mean_accuracy([matching_accuracy(idx0, gt, n_pairs=n_pairs) for idx0 in all_idx0])
        return loss_outputs(cfg, terms, all_idx0[-1], all_ms0[-1], acc)
