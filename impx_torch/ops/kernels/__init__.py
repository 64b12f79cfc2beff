"""Hand-written CUDA kernels for Hopper: wrappers, plain versions, build.

Importing the package registers the inference kernels as `torch.library`
ops (impx::mha_fwd, impx::mha_fwd_lse, impx::attention_key_mass,
impx::sinkhorn_stats, impx::log_sinkhorn_stats, impx::norm_act), which a program loaded by
impx_torch/tools/export.py:load_matcher calls.
"""
from impx_torch.ops.kernels import attention, log_sinkhorn, norm, sinkhorn  # noqa: F401  (registers the ops)
