"""The benchmark's one adapter to the program under test (impx_torch): the
matcher built from a configuration file with the benchmark's weights, and
its CUDA kernels built or loaded. Drivers call the program only through
these and through the entry points they name."""
from __future__ import annotations


def matcher_config(config: dict, **changes):
    from impx_torch.models.config import MatcherConfig

    m = {**config["matcher"], **changes}
    m["keypoint_encoder"] = tuple(m["keypoint_encoder"])
    m["compaction"] = tuple(tuple(x) for x in m.get("compaction", ()))
    return MatcherConfig(**m)


def build_model(config: dict, weights: dict, device, **changes):
    from impx_torch.models.adgm import AdaGMN
    from impx_torch.models.dgnns import DGNNS

    cls = {"DGNNS": DGNNS, "AdaGMN": AdaGMN}[config["model"]]
    model = cls(matcher_config(config, **changes), device=device, seed=0)
    model.load_state_dict(weights, strict=True)
    return model


def build_kernels(names: list, device) -> float:
    """Build (first run) or load the named CUDA sources; seconds taken."""
    if device.type != "cuda":
        return 0.0
    from impx_torch.ops.kernels import _build

    seconds, _ = _build.build_seconds(tuple(names))
    return seconds
