"""impx_torch — the IMP matcher in PyTorch, with hand-written CUDA kernels for Hopper.

A port of `impx` (JAX/Pallas) that mirrors its module layout:

  models/   config, gnn, gm, dgnns, adgm, superglue, fast, loss (the matchers
            as nn.Modules, their forwards and the training loss), superpoint
            (the detector and descriptor)
  ops/      norms, mlp, attention, sinkhorn, matching (plain tensor functions)
  ops/kernels/  the CUDA kernels' wrappers, each beside its plain version
  geometry/ keypoints, epipolar, pose (errors, AUC), triangulation,
            reprojection (depth reprojection, ground-truth matches), misc
  ransac/   eight_point, five_point, ransac, pose_solver (the device and cv2
            pose backends, the iterative loop's checkpoint solver),
            fundamental (the device F backend of the FM bench)
  data/     reader (the standard HDF5 dump), synthetic (seeded two-view pairs),
            megadepth (the training datasets), extractors (SuperPoint, SIFT,
            the component registry), sift_native, dump/ (the YFCC, ScanNet
            and MegaDepth dumps, the downloader)
  eval/     evaluator (pose AUC, FM bench), eval_imp (the eval CLI),
            eval_full, pipeline, iterative (the match-pose loop with early
            stopping), reproduce (download -> dump -> eval)
  train/    step (Adam, LR schedule, NaN guard), trainer, train (the CLI)
  tools/    convert (weights from the JAX pytree, the reference state_dict or
            a reference checkpoint file), viz (match drawings), the *_phases
            timing tools
  demo.py   the two-image demo
  csrc/     the CUDA C++ sources, built at first use by ops/kernels/_build.py

The package imports torch and never jax. Entry points run on the CUDA device
unless the caller passes device="cpu"; on CPU tensors every kernel wrapper
runs its plain PyTorch version.
"""
from impx_torch.device import resolve_device

__all__ = ["resolve_device"]
