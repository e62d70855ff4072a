"""Each plain reference against the program's plain CPU path, in float32,
on the program's smoke configuration of the family: the same weights
and batches through the followed train steps give the same losses,
first gradients and changes."""

import math

import pytest
import torch

from perfbench import bench, check, traffic
from perfbench.reference import common
from perfbench.smoke import small_cell

CELLS = ("glm4-9b.train-4k", "mamba2-1.3b.train-2k")


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_programs_fp32_path(name):
    cell = small_cell(name, amp="O0")
    prog = bench.Program(cell, 2 ** 31 + 7, "cpu")
    mine = prog.follow()
    prog.close()
    ref = bench.reference(cell, 2 ** 31 + 7, "cpu")
    for a, b in zip(mine.losses, ref.losses):
        assert a == pytest.approx(b, rel=2e-6)
    for k, g in ref.grad_norms.items():
        assert mine.grad_norms[k] == pytest.approx(g, rel=1e-4, abs=1e-9), k
    for k, c in ref.change_norms.items():
        assert mine.change_norms[k] == pytest.approx(c, rel=1e-4), k
    nums, _ = check.numbers(mine, ref)
    # Adam moves an element whose gradient is near 0 by ±lr on the sign
    # of its rounding: the change's elements may differ where the
    # gradient's agree
    assert max(v for k, v in nums.items() if k != "change_diff_med") < 1e-4
    assert nums["change_diff_med"] < 1e-2


@pytest.mark.parametrize("name", CELLS)
def test_reference_logits_follow_the_programs_forward(name):
    """The loss of one batch on the same weights, the reference's against
    the program's ``loss_fn`` at O0 (fp32)."""
    cell = small_cell(name, amp="O0")
    prog = bench.Program(cell, 11, "cpu")
    batch = prog.pool[0]
    theirs = prog.model.loss_fn(prog.state.params, batch, prog.run)[0]
    weights = cell.weights(11, "cpu").all()
    mine = cell.reference().loss(weights, batch, cell.model,
                                 common.Products("fp32"))
    assert float(mine) == pytest.approx(float(theirs), rel=2e-6)


def test_the_pool_is_the_seeds_and_zipf():
    mix = {"kind": "train", "batch": 2, "seq_len": 512, "pool": 8,
           "tokens": {"marginal": "zipf", "exponent": 1.0}}
    a = traffic.pool(mix, 1000, 2 ** 33 + 5, "cpu")
    b = traffic.pool(mix, 1000, 2 ** 33 + 5, "cpu")
    c = traffic.pool(mix, 1000, 2 ** 33 + 6, "cpu")
    assert len(a) == 8 and all(x["tokens"].shape == (2, 512) for x in a)
    assert all(torch.equal(x["tokens"], y["tokens"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])
    # targets are the tokens one position on
    assert torch.equal(a[0]["tokens"][:, 1:], a[0]["targets"][:, :-1])
    # distinct batches, ids in range, id 0 the most frequent
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    ids = torch.cat([x["tokens"].flatten() for x in a])
    assert int(ids.min()) >= 0 and int(ids.max()) < 1000
    counts = torch.bincount(ids.long(), minlength=1000)
    # Zipf s = 1 over 1000 ids: id 0 carries 1 / H_1000 ≈ 13.4%
    assert float(counts[0]) / ids.numel() == pytest.approx(
        1 / sum(1 / r for r in range(1, 1001)), rel=0.1)
    assert int(counts.argmax()) == 0


def test_weights_remade_leaf_by_leaf_are_the_same():
    from perfbench.reference import mamba2
    m = {"n_layers": 2, "d_model": 32, "vocab_size": 100, "ssm_state": 8,
         "ssm_expand": 2, "ssm_head_dim": 16, "ssm_n_groups": 1,
         "ssm_conv_width": 4, "tie_embeddings": True}
    w = bench.Weights(mamba2.layout(m), 2 ** 32 + 1, "cpu")
    every = w.all()
    for path, t in every.items():
        assert torch.equal(w.leaf(path), t)
    a = every["blocks/ssm/A_log"].exp()
    assert float(a.min()) >= 1 and float(a.max()) <= 16
    dt = torch.nn.functional.softplus(every["blocks/ssm/dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    other = bench.Weights(mamba2.layout(m), 2 ** 32 + 2, "cpu").all()
    assert not torch.equal(other["blocks/ssm/in_proj"],
                           every["blocks/ssm/in_proj"])
    assert math.isclose(float(every["blocks/ssm/in_proj"].std()),
                        32 ** -0.5, rel_tol=0.1)


def test_the_top_layer_is_sampled_apart_from_the_stack():
    t = torch.arange(4 * 300 * 300, dtype=torch.float32).reshape(4, 300, 300)
    plan = common.sample_plan(2 ** 31 + 3, {"blocks/mlp/w_up": t,
                                            "ln_f/scale": t[0, 0]})
    assert set(plan["blocks/mlp/w_up"]) == {"blocks/mlp/w_up",
                                            "blocks/mlp/w_up" + common.TOP}
    assert set(plan["ln_f/scale"]) == {"ln_f/scale"}
    top = plan["blocks/mlp/w_up"]["blocks/mlp/w_up" + common.TOP]
    per = 300 * 300
    # the top layer's own elements, drawn from the seed
    assert len(top) == common.SAMPLE
    assert int(top.min()) >= 3 * per and int(top.max()) < 4 * per
    again = common.sample_plan(2 ** 31 + 3, {"blocks/mlp/w_up": t})
    assert torch.equal(again["blocks/mlp/w_up"]["blocks/mlp/w_up"
                                                + common.TOP], top)
    # ln_f/scale (300 elements) is kept whole
    assert torch.equal(plan["ln_f/scale"]["ln_f/scale"], torch.arange(300))
