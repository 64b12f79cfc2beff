"""The plain reference against impx_torch's CPU path (its kernels' plain
versions) at small sizes: IMP at 2 layers and EIMP with one compaction at 6,
64 keypoint slots; one IMP training step's loss and every gradient leaf."""
from __future__ import annotations

import pytest
import torch

from conftest import small_cell


def setup(name: str, seed: int = 5):
    from benchlib import core, weights
    from benchlib.program import build_model

    cell = small_cell(name)
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    W = weights.make_weights(cell.config, gen, dev)
    pool = core.generator_module(cell.traffic).make_pool(cell.traffic, cell.config["matcher"]["descriptor_dim"],
                                                         gen, dev)
    return cell, W, pool, build_model(cell.config, W, dev)


@pytest.mark.parametrize("name", ["imp_match_yfcc", "eimp_match_compact"])
def test_matches_agree_with_the_program(name):
    from reference import matcher as ref

    cell, W, pool, model = setup(name)
    m = cell.config["matcher"]
    for batch in pool[:2]:
        with torch.no_grad():
            out = model.produce_matches(batch, p=m["match_threshold"], only_last=True, with_scores=False)
            want = (ref.eimp_matches if cell.config["model"] == "AdaGMN" else ref.imp_matches)(ref.Plain(), W, m, batch)
        valid = batch["valid0"]
        assert torch.equal(out["indices0"][-1][valid], want["indices0"][valid])
        assert (want["indices0"] >= 0).sum() > 0, "the traffic must give matches"
        torch.testing.assert_close(out["mscores0"][-1][valid], want["mscores0"][valid], rtol=1e-5, atol=1e-6)
        if cell.config["model"] == "AdaGMN":
            for k in ("keep0", "keep1", "overflow0", "overflow1"):
                assert torch.equal(out[k].long(), want[k].long()), k
            assert int(want["keep0"].sum()) < int(valid.sum()), "pooling must drop keypoints"


def test_one_training_step_agrees_with_the_program():
    from reference import matcher as ref

    cell, W, pool, model = setup("imp_train_megadepth")
    batch = pool[0]
    out = model.forward_train(batch)
    out["loss"].backward()
    params = {k: t.clone().requires_grad_(True) for k, t in W.items()}
    loss = ref.train_loss(ref.Plain(), params, cell.config["matcher"], batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.testing.assert_close(out["loss"].detach(), loss.detach(), rtol=1e-5, atol=0.0)
    got = dict(model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads)
    for (name, _), g in zip(params.items(), grads):
        torch.testing.assert_close(got[name].grad, g, rtol=1e-3, atol=1e-5 * scale, msg=name)
