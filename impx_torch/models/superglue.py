"""SuperGlue (impx/models/superglue.py): GM without attention sharing, one
final projection shared by every iteration, and the log-domain optimal
transport head, whatever config.log_ot says. Its published configuration
(magicleap/SuperGluePretrainedNetwork, models/superglue.py `default_config`:
descriptor 256, keypoint encoder (32, 64, 128, 256), 4 heads, 9 x (self,
cross) layers, 100 Sinkhorn iterations, match threshold 0.2) is
MatcherConfig(norm_fn='bn', sinkhorn_iterations=100) at the defaults' widths.

Its MLPs normalise with batch norm from running statistics. Both images of
every pair go through each layer in one call, stacked on the batch axis, as
DGNNS's forward does: from running statistics batch norm is a per-channel
affine map and attention runs pair by pair, so the stack computes impx's
unrolled GM.forward_one_layer (impx/models/gm.py:159-183) with half the
attention launches. Pairs with unequal keypoint counts go through GM's
unrolled forward (one launch an image), as impx's SuperGlue, a GM, takes
them (impx/models/gm.py:196-221). The model is built in eval mode, which
chooses nothing: each call names its statistics.

Training is GM's unrolled forward_train (impx's SuperGlue trains through
GM.forward_train): the keypoint encoder normalises from each image's batch
statistics, one image at a time; the layers, stacked, from the running
statistics, which then take their gradient; after each of the 9 cross
layers the shared final projection, the log-domain head (kernel 7's forward
under LogOTFused) and graph_loss of the log plan.

The dtype contract is GM's (impx/ops/attention.py:114-120), not the fast
path's: the stream stays fp32, q/k/v are projected in fp32 and cast to the
compute dtype for the attention kernel, whose output is cast back to fp32
for the merge and the MLP. The score head is impx's attn_impl='pallas' one
(the log-Sinkhorn kernel, then the fp32 log plan); matches come from the
exponentiated plan, as impx's GM.produce_matches takes them.
"""
from __future__ import annotations

from typing import Any

import torch

from impx_torch.models.fast import _encode, _swap_half
from impx_torch.models.gm import GM


class SuperGlue(GM):
    sharing = False

    def __init__(self, config, device: str | torch.device | None = None, seed: int = 0,
                 use_kernels: bool = True):
        super().__init__(config, device, seed, use_kernels)
        # one projection shared by every iteration (impx/models/superglue.py:27-31)
        self.final_proj = self.final_proj[:1]
        self.eval()

    @property
    def scores_are_log(self) -> bool:
        return True

    def compute_distance(self, desc0, desc1, layer_id: int = -1):
        """The shared final projection + scaled dot product
        (impx/models/superglue.py:33-38)."""
        return super().compute_distance(desc0, desc1, layer_id=0)

    @torch.no_grad()
    def produce_matches(self, data: dict[str, Any], p: float = 0.2, only_last: bool = False, **_):
        """Matches for a batch of pairs (impx/models/gm.py:196-221): data as
        DGNNS.produce_matches takes it. Returns lists, one entry per cross
        layer or the last only, under 'scores' (the fp32 log plan
        [B, N+1, M+1]), 'indices0' (-1 = unmatched) and 'mscores0'. The
        stacked loop below needs N0 == N1; other pairs take GM's unrolled
        forward. Other keywords (with_scores, which the serving export
        passes) are ignored, as impx's GM.produce_matches takes them."""
        cfg = self.config
        data = self._on_device(data)
        if data["descriptors0"].shape[1] != data["descriptors1"].shape[1]:
            return GM.produce_matches(self, data, p=p, only_last=only_last)
        desc, valid0, valid1, b, _ = _encode(self, data, torch.float32)
        mask = torch.cat([valid0, valid1], dim=0)
        mask_swap = torch.cat([valid1, valid0], dim=0)
        kw = dict(ac_fn=cfg.ac_fn, use_kernels=self.use_kernels, attn_dtype=self.compute_dtype)
        descs = []
        for i in range(cfg.n_layers):
            delta, _ = self.gnn[2 * i](desc, desc, None, mask, mask, **kw)
            desc = desc + delta
            delta, _ = self.gnn[2 * i + 1](desc, _swap_half(desc), None, mask_swap, mask, **kw)
            desc = desc + delta
            if not only_last or i == cfg.n_layers - 1:
                descs.append(desc)

        out = {"scores": [], "indices0": [], "mscores0": []}
        for d in descs:
            score = self.compute_score(self.compute_distance(d[:b], d[b:]), valid0, valid1)
            idx0, _, ms0, _ = self.compute_matches(score, p=p, valid0=valid0, valid1=valid1)
            out["scores"].append(score)
            out["indices0"].append(idx0)
            out["mscores0"].append(ms0)
        return out

    def run(self, data: dict[str, Any]):
        """SGMNet-style eval API (impx/models/gm.py:298-312): desc1/desc2,
        x1/x2 = (x, y, score) with normalized keypoints, optional valid0/1.
        Returns the last log plan 'p' and the lists 'indices0', 'mscores0'."""
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
        out = self.produce_matches(feed, p=self.config.match_threshold, only_last=True)
        return {"p": out["scores"][-1], "indices0": out["indices0"], "mscores0": out["mscores0"]}
