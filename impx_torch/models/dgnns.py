"""DGNNS — the IMP matcher: GM with attention sharing (impx/models/dgnns.py).

The layers that share (MatcherConfig.sharing_layers(True)) are built without
q/k weights and attend with the q/k carried from the previous layer of their
kind. With norm_fn='in' and the same keypoint count in both images the
forward is the stacked-batch one of impx/models/fast.py; otherwise GM's
unrolled forward, as impx routes every config but (pallas, 'in')
(impx/models/dgnns.py:29-46). Batch norm (norm_fn='bn') runs from running
statistics at inference. Training under it is GM's unrolled forward, whose
keypoint encoder normalises from each image's batch statistics and whose
layers from the running statistics. The model is built in eval mode, which
chooses nothing: each call names its statistics.
"""
from __future__ import annotations

import torch

from impx_torch.models.fast import forward_scan, forward_train_scan
from impx_torch.models.gm import GM
from impx_torch.tools.profiling import span


class DGNNS(GM):
    sharing = True

    def __init__(self, config, device=None, seed: int = 0, use_kernels: bool = True):
        super().__init__(config, device, seed, use_kernels)
        if config.norm_fn == "bn":
            self.eval()

    @torch.no_grad()
    def produce_matches(self, data, p: float = 0.2, only_last: bool = False,
                        with_scores: bool = True):
        """Matches for a batch of pairs (impx/models/dgnns.py:22).

        data: descriptors0/1 [B, N, D], norm_keypoints0/1 [B, N, 2] (or
        keypoints0/1 with image_shape0/1), scores0/1 [B, N], optional
        valid0/1 [B, N] bool; arrays or tensors. Returns lists (one entry per
        collected iteration, or the last only) under 'scores' (the fp32
        [B, N+1, M+1] plan, or None when with_scores=False), 'indices0'
        (-1 = unmatched) and 'mscores0'. With norm_fn='in' and the same
        keypoint count in both images the stacked forward runs; otherwise
        GM's unrolled one under GM's dtype contract, as impx's routing does
        (its scan needs 'in' and equal counts)."""
        with span("impx.match"):
            data = self._on_device(data)
            if (self.config.norm_fn != "in"
                    or data["descriptors0"].shape[1] != data["descriptors1"].shape[1]):
                return GM.produce_matches(self, data, p=p, only_last=only_last, with_scores=with_scores)
            return forward_scan(self, data, p=p, only_last=only_last, with_scores=with_scores)

    def forward_train(self, data):
        """Training forward (impx/models/dgnns.py:37): `produce_matches`'s
        data plus matching_mask [B, N+1, M+1], on the model's device or moved
        there. Differentiable; returns the dict of
        impx_torch/models/fast.py:train_outputs (loss, its terms, matches0,
        matching_scores0, accuracy counters). With norm_fn='in' and the same
        keypoint count in both images the stacked forward
        (fast.py:forward_train_scan); otherwise GM's unrolled one, as
        `produce_matches` routes. config.train_fused picks route B's
        attention core, config.train_supervision the supervised iterations.
        norm_fn='bn' takes GM's forward, as impx routes it
        (impx/models/dgnns.py:37-46)."""
        data = self._on_device(data)
        if (self.config.norm_fn != "in"
                or data["descriptors0"].shape[1] != data["descriptors1"].shape[1]):
            return GM.forward_train(self, data)
        return forward_train_scan(self, data)

    def pool(self, *args, **kwargs):
        """No pooling in IMP (impx/models/dgnns.py:48)."""
        return None, None

    def run(self, data):
        """Eval API (impx/models/dgnns.py:52): desc1/desc2, x1/x2 = (x, y,
        score) with normalized keypoints, optional valid0/1."""
        feed = {
            "descriptors0": data["desc1"],
            "descriptors1": data["desc2"],
            "norm_keypoints0": data["x1"][..., :2],
            "norm_keypoints1": data["x2"][..., :2],
            "scores0": data["x1"][..., -1],
            "scores1": data["x2"][..., -1],
        }
        for k in ("valid0", "valid1"):
            if data.get(k) is not None:
                feed[k] = data[k]
        out = self.produce_matches(feed, p=self.config.match_threshold,
                                   only_last=True, with_scores=False)
        return {"indices0": out["indices0"][-1], "mscores0": out["mscores0"][-1]}
