"""Iterative matching <-> pose estimation with early stopping
(impx/eval/iterative.py), IMP's signature algorithm.

Two attention layers (self, cross) a step; at the checkpoint iterations
(VALID_ITS) the matches of that iteration's final projection and Sinkhorn
plan give a relative pose, and the loop stops once the pose moved at most
pose_stop_deg since the previous checkpoint, which skips the remaining
layers' work. The host reads one bool a checkpoint (all pairs converged) and
nothing inside it.

  * The layers step through GM's stacked layer API
    (`GM.forward_stacked_layer`): both images of every pair in one launch of
    kernel 1 a layer, the stream in fp32 and the attention core in the
    compute dtype (GM's contract, as impx's loop runs `_apply_layer`).
  * A checkpoint scores through GM.compute_score (the plain dustbin
    Sinkhorn, as impx's does: pooling and the matches need the whole plan),
    then solves every pair's pose in one batched call of
    `estimate_pose_from_matches` (impx vmaps it over pairs): each pair draws
    from its own torch.Generator, so a pair's samples do not depend on the
    batch it is in, and the serial and the batched loops give it the same.
  * EIMP with uncertainty pools the keep masks after each checkpoint with
    the threshold mscore_base * the pose's inlier ratio a pair; on the kernel
    path the checkpoint's layers run kernel 4, whose row lse the key-mass
    kernel (6) takes.

Semantics kept from impx: fewer than min_kpts matches gives no pose at that
checkpoint; the pose difference is taken, then the pose updated, then the
stop decided; a converged pair outputs its pose inliers; a pair that never
converges falls back to matches at p = 0.2 from the last score under the
keep masks of the last pool. `_run_cv2` is the reference protocol: host cv2
USAC_MAGSAC at each checkpoint, on pixel coordinates and the real K.

`checkpoint_backend` 'device' (impx's 'jax', accepted as a synonym) or
'cv2'. impx splits one PRNG key into a jit program per layer index; eager
PyTorch needs neither.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from impx_torch.ransac.pose_solver import estimate_pose_from_matches, prior_essential

VALID_ITS = (3, 5, 7, 9, 11, 13, 14)  # the reference's checkpoint iterations
CHECKPOINT_BACKENDS = {"device": "device", "jax": "device", "cv2": "cv2"}


def _pose_diff_deg(R1, t1, R2, t2):
    """max(rotation angle, translation direction angle) in degrees between
    poses [..., 3, 3], [..., 3]."""
    cos_r = torch.clamp((torch.sum(R1 * R2, dim=(-2, -1)) - 1.0) / 2.0, -1.0, 1.0)
    dr = torch.rad2deg(torch.abs(torch.arccos(cos_r)))
    n = torch.linalg.norm(t1, dim=-1) * torch.linalg.norm(t2, dim=-1)
    dt = torch.rad2deg(torch.arccos(torch.clamp(torch.sum(t1 * t2, dim=-1) / (n + 1e-15), -1.0, 1.0)))
    return torch.maximum(dr, dt)


class IterativeMatcher:
    """The iterative loop of one model (DGNNS, or AdaGMN with uncertainty).

    norm_thresh: the RANSAC threshold in normalized coordinates (each run may
    override it: intrinsics vary over a dataset). num_hypotheses: minimal
    sets a checkpoint; sample_size 5 (the five-point solver, impx's default)
    or 8. group: the data-parallel ranks that run the loop together, each on
    its own pairs (eval --data_parallel); the batch stops when every pair of
    every rank has converged."""

    def __init__(self, model, *, norm_thresh: float, match_ratio: float = 0.1, min_kpts: int = 25,
                 pose_stop_deg: float = 1.5, num_hypotheses: int = 256, with_uncertainty: bool = False,
                 mscore_base: float = 0.2, valid_its: Sequence[int] = VALID_ITS, sample_size: int = 5,
                 checkpoint_backend: str = "device", group=None):
        if checkpoint_backend not in CHECKPOINT_BACKENDS:
            raise ValueError(f"unknown checkpoint_backend {checkpoint_backend!r} "
                             f"(expected one of {sorted(CHECKPOINT_BACKENDS)})")
        if with_uncertainty and not hasattr(model, "pool_masks_stacked"):
            raise ValueError("with_uncertainty pools keypoints: it needs an AdaGMN (EIMP) model")
        self.model = model
        self.valid_its = tuple(valid_its)
        self.norm_thresh = norm_thresh
        self.match_ratio = match_ratio
        self.min_kpts = min_kpts
        self.pose_stop_deg = pose_stop_deg
        self.num_hypotheses = num_hypotheses
        self.sample_size = sample_size
        self.with_uncertainty = with_uncertainty
        self.mscore_base = mscore_base
        self.checkpoint_backend = CHECKPOINT_BACKENDS[checkpoint_backend]
        self.group = group

    # ------------------------------------------------------------- the pieces
    def _encode(self, data: dict[str, Any]):
        """(desc [2B, N, D] fp32, image 0 then image 1, valid0, valid1 [B, N])."""
        desc0, desc1, valid0, valid1 = self.model._encode_inputs(data)
        return torch.cat([desc0, desc1]), valid0, valid1

    def _step(self, ni: int, desc, state, keep0, keep1, with_lse: bool = False):
        """Iteration ni's self and cross layers on the stacked stream, keys and
        InstanceNorm under the keep masks. Returns (desc, state, (lse_self,
        lse_cross) or None)."""
        keep, keep_swap = torch.cat([keep0, keep1]), torch.cat([keep1, keep0])
        desc, state, lse_self = self.model.forward_stacked_layer(desc, 2 * ni, state, keep, keep_swap, keep,
                                                                 with_lse)
        desc, state, lse_cross = self.model.forward_stacked_layer(desc, 2 * ni + 1, state, keep, keep_swap,
                                                                  keep, with_lse)
        return desc, state, (None if lse_self is None else (lse_self, lse_cross))

    def _match_at(self, ni: int, desc, keep0, keep1):
        """Iteration ni's plan (final_proj[ni], the Sinkhorn head under the keep
        masks) and its mutual-NN matches at match_ratio: (score, idx0, ms0)."""
        model = self.model
        b = keep0.shape[0]
        score = model.compute_score(model.compute_distance(desc[:b], desc[b:], layer_id=ni), keep0, keep1)
        idx0, _, ms0, _ = model.compute_matches(score, p=self.match_ratio, valid0=keep0, valid1=keep1)
        return score, idx0, ms0

    def _solve_pose(self, generators, x0n, x1n, idx0, ms0, norm_threshs, E_init, samples=None):
        return estimate_pose_from_matches(generators, x0n, x1n, idx0, ms0, norm_threshs,
                                          num_hypotheses=self.num_hypotheses,
                                          sample_size=self.sample_size, E_init=E_init, samples=samples)

    def _check(self, ni: int, desc, keep0, keep1, x0n, x1n, state: dict, generators, norm_threshs,
               samples=None):
        """One convergence check of every pair (impx's _check_impl and
        _check_batched_impl): matches, the pose warm-started from the
        previous checkpoint's, the pose difference, then the update; pairs
        converged before keep their outputs. Returns (state, score,
        inlier_ratio [B], all converged: a 0-dim bool on the device)."""
        score, idx0, ms0 = self._match_at(ni, desc, keep0, keep1)
        m_valid = idx0 > -1
        n_matches = m_valid.sum(dim=1)
        pose = self._solve_pose(generators, x0n, x1n, idx0, ms0, norm_threshs,
                                prior_essential(state["R"], state["t"], state["has_pose"]), samples)
        enough = n_matches >= self.min_kpts
        pose_ok = pose["num_inliers"] >= 5
        diff = torch.where(state["has_pose"] & pose_ok & enough,
                           _pose_diff_deg(state["R"], state["t"], pose["R"], pose["t"]), torch.inf)
        active = ~state["converged"]
        newly = enough & (diff <= self.pose_stop_deg) & active
        upd = active & enough & pose_ok
        inlier_idx0 = torch.where(m_valid & pose["inliers"], idx0, -1)
        state = {
            "R": torch.where(upd[:, None, None], pose["R"], state["R"]),
            "t": torch.where(upd[:, None], pose["t"], state["t"]),
            "has_pose": torch.where(active, enough & pose_ok, state["has_pose"]),
            # newly converged pairs keep their pose inliers; active ones the
            # latest matches; converged ones what they had
            "indices0": torch.where(newly[:, None], inlier_idx0,
                                    torch.where(active[:, None], idx0, state["indices0"])),
            "mscores0": torch.where(active[:, None], ms0, state["mscores0"]),
            "stopped_at": torch.where(newly, ni + 1, state["stopped_at"]),
            "converged": state["converged"] | newly,
        }
        inlier_ratio = torch.where(n_matches > 0, pose["num_inliers"] / n_matches.clamp(min=1), 0.0)
        return state, score, inlier_ratio, state["converged"].all()

    def _pool(self, score, qk_state, keep0, keep1, mscore_th, active, lse=None):
        """Uncertainty pooling with a threshold a pair, mscore_th [B, 1];
        frozen pairs keep their masks. lse: the row lse of the checkpoint's
        two layers (the kernel path), which the key masses take."""
        new0, new1 = self.model.pool_masks_stacked(score, qk_state["self"], qk_state["cross"], keep0, keep1,
                                                   mscore_th, *(lse or (None, None)))
        return torch.where(active[:, None], new0, keep0), torch.where(active[:, None], new1, keep1)

    # --------------------------------------------------------------- the loops
    def _loop(self, data: dict[str, Any], generators, norm_threshs) -> dict:
        """The loop over B pairs (impx's run_batch): data the standard feed
        [B, ...] plus x0n/x1n [B, N, 2]; generators one a pair; norm_threshs
        [B]."""
        model = self.model
        n_layers = model.config.n_layers
        data = model._on_device(data)
        desc, keep0, keep1 = self._encode(data)
        b, n = keep0.shape
        dev = desc.device
        norm_threshs = torch.as_tensor(norm_threshs, dtype=torch.float32, device=dev).expand(b)
        state = {"R": torch.eye(3, device=dev).expand(b, 3, 3), "t": torch.zeros((b, 3), device=dev),
                 "has_pose": torch.zeros((b,), dtype=torch.bool, device=dev),
                 "indices0": torch.full((b, n), -1, dtype=torch.long, device=dev),
                 "mscores0": torch.zeros((b, n), device=dev),
                 "stopped_at": torch.full((b,), n_layers, dtype=torch.long, device=dev),
                 "converged": torch.zeros((b,), dtype=torch.bool, device=dev)}
        qk = model.init_state()
        score = None
        for ni in range(n_layers):
            check = ni in self.valid_its
            desc, qk, lse = self._step(ni, desc, qk, keep0, keep1, with_lse=check and self.with_uncertainty)
            if not check:
                continue
            active = ~state["converged"]
            state, score, ratio, all_done = self._check(ni, desc, keep0, keep1, data["x0n"], data["x1n"],
                                                        state, generators, norm_threshs)
            if self.with_uncertainty:
                th = torch.where(ratio > 0, self.mscore_base * ratio, self.mscore_base)[:, None]
                keep0, keep1 = self._pool(score, qk, keep0, keep1, th, active, lse)
            if self.group is not None:  # every rank's pairs (impx: an XLA all-reduce)
                from impx_torch.parallel.collectives import pmax

                all_done = pmax((~all_done).to(torch.int32).reshape(1), self.group)[0] == 0
            if bool(all_done):  # the one host read a checkpoint
                break
        if score is not None:
            # pairs that never converged: matches at p = 0.2 from the last
            # score, under the keep masks of the last pool
            idx0, _, ms0, _ = model.compute_matches(score, p=0.2, valid0=keep0, valid1=keep1)
            conv = state["converged"][:, None]
            state["indices0"] = torch.where(conv, state["indices0"], idx0)
            state["mscores0"] = torch.where(conv, state["mscores0"], ms0)
        return state

    @torch.no_grad()
    def run(self, data: dict[str, Any], generator: torch.Generator | None = None,
            norm_thresh: float | None = None) -> dict[str, Any]:
        """One pair: descriptors0/1 [1, N, D], norm_keypoints0/1 [1, N, 2],
        scores0/1 [1, N], valid0/1 [1, N], x0n/x1n [N, 2] intrinsics-normalized
        (arrays or tensors); the cv2 backend also takes x0px/x1px (pixels),
        K0/K1 and error_th_px. generator: the pair's, on the model's device
        (the device backend). norm_thresh overrides the constructor's.

        Returns indices0, mscores0 [N], R, t, has_pose (tensors, or numpy
        under cv2), stopped_at (int), converged (bool)."""
        norm_thresh = self.norm_thresh if norm_thresh is None else norm_thresh
        if self.checkpoint_backend == "cv2":
            return self._run_cv2(data, norm_thresh)
        data = dict(data)
        for k in ("x0n", "x1n"):
            data[k] = torch.as_tensor(data[k]).reshape(1, -1, 2)
        out = self._loop(data, [generator], [norm_thresh])
        return {"indices0": out["indices0"][0], "mscores0": out["mscores0"][0], "R": out["R"][0],
                "t": out["t"][0], "has_pose": out["has_pose"][0], "stopped_at": int(out["stopped_at"][0]),
                "converged": bool(out["converged"][0])}

    @torch.no_grad()
    def _run_cv2(self, data: dict[str, Any], norm_thresh) -> dict[str, Any]:
        """The reference protocol's checkpoints (impx/eval/iterative.py:254):
        host cv2 USAC_MAGSAC at every checkpoint on the matched coordinates.
        With x0px/x1px in the feed, cv2 gets pixel coordinates in the
        reader's dtype (float32) and K0/K1 in float64, as the reference feeds
        it: its USAC is not scale-invariant, and its model differs between
        float32 and float64 inputs. Otherwise the normalized x0n/x1n with
        identity K. Too few matches resets the pose; no convergence returns
        no pose, with the p = 0.2 matches of the last score."""
        from impx_torch.ransac.pose_solver import estimate_pose_cv2

        model = self.model
        n_layers = model.config.n_layers
        host = ("x0px", "x1px", "K0", "K1", "error_th_px", "x0n", "x1n")
        if "x0px" in data:
            x0, x1 = np.asarray(data["x0px"]), np.asarray(data["x1px"])
            K0, K1 = np.asarray(data["K0"], np.float64), np.asarray(data["K1"], np.float64)
            norm_thresh = float(data.get("error_th_px", 1.0))
        else:
            x0, x1 = (np.asarray(data[k], np.float64).reshape(-1, 2) for k in ("x0n", "x1n"))
            K0 = K1 = np.eye(3)
        feed = model._on_device({k: v for k, v in data.items() if k not in host})
        desc, keep0, keep1 = self._encode(feed)
        qk = model.init_state()
        last_R = last_t = score = None
        for ni in range(n_layers):
            check = ni in self.valid_its
            desc, qk, lse = self._step(ni, desc, qk, keep0, keep1, with_lse=check and self.with_uncertainty)
            if not check:
                continue
            score, idx0, ms0 = self._match_at(ni, desc, keep0, keep1)
            idx0_np, ms0_np = idx0[0].cpu().numpy(), ms0[0].cpu().numpy()
            mids0 = np.where(idx0_np > -1)[0]
            if mids0.size < self.min_kpts:
                last_R = last_t = None   # too few matches resets the pose
                continue
            ret = estimate_pose_cv2(x0[mids0], x1[idx0_np[mids0]], K0, K1, float(norm_thresh))
            if ret is not None:
                _, R, t, inliers = ret
            else:
                R = t = None
                inliers = np.zeros(mids0.size, bool)
            # in float64 on the host, as impx's cv2 loop takes it
            f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64).reshape(-1, 3))  # noqa: E731
            pose_diff = (float(_pose_diff_deg(f64(last_R), f64(last_t)[0], f64(R), f64(t)[0]))
                         if last_R is not None and R is not None else np.inf)
            last_R, last_t = R, t
            if self.with_uncertainty:
                ir = float(np.sum(inliers)) / max(mids0.size, 1) if R is not None else 0.0
                th = torch.full((1, 1), self.mscore_base * ir if ir > 0 else self.mscore_base,
                                device=desc.device)
                keep0, keep1 = self._pool(score, qk, keep0, keep1, th,
                                          torch.ones((1,), dtype=torch.bool, device=desc.device), lse)
            if pose_diff <= self.pose_stop_deg:
                out_idx = np.full_like(idx0_np, -1)
                sel = mids0[np.asarray(inliers, bool)]
                out_idx[sel] = idx0_np[sel]
                return {"indices0": out_idx, "mscores0": ms0_np, "R": R, "t": np.asarray(t).ravel(),
                        "has_pose": True, "stopped_at": ni + 1, "converged": True}
        idx0, _, ms0, _ = model.compute_matches(score, p=0.2, valid0=keep0, valid1=keep1)
        return {"indices0": idx0[0].cpu().numpy(), "mscores0": ms0[0].cpu().numpy(), "R": np.eye(3),
                "t": np.zeros(3), "has_pose": False, "stopped_at": n_layers, "converged": False}


def matching_iterative_ondevice(model, data, generator, *, norm_thresh, match_ratio=0.1, min_kpts=25,
                                pose_stop_deg=1.5, num_hypotheses=1024, with_uncertainty=False,
                                mscore_base=0.2):
    """One-shot wrapper (impx/eval/iterative.py:355): builds an
    IterativeMatcher and runs one pair."""
    return IterativeMatcher(model, norm_thresh=norm_thresh, match_ratio=match_ratio, min_kpts=min_kpts,
                            pose_stop_deg=pose_stop_deg, num_hypotheses=num_hypotheses,
                            with_uncertainty=with_uncertainty, mscore_base=mscore_base).run(data, generator)


class BatchedIterativeMatcher(IterativeMatcher):
    """B pairs through the loop together (impx/eval/iterative.py:368): each
    pair freezes its outputs at its own stopping checkpoint, and the batch
    stops when every pair has converged. Converged pairs ride along until
    then; their keep masks stay as they were."""

    @torch.no_grad()
    def run_batch(self, data: dict[str, Any], generators: Sequence[torch.Generator],
                  norm_threshs) -> dict[str, torch.Tensor]:
        """data: the standard feed [B, ...] plus x0n/x1n [B, N, 2];
        generators: one a pair, on the model's device; norm_threshs [B].
        Returns per-pair tensors: indices0, mscores0 [B, N], R [B, 3, 3],
        t [B, 3], has_pose, stopped_at, converged [B]."""
        return self._loop(data, generators, norm_threshs)
