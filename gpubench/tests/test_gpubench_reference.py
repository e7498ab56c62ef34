"""The plain references against the port on the CPU at a small size, and
their lower-precision controls reading above the port."""
import pytest

from conftest import context, small_cell


@pytest.fixture(scope="module")
def shgn_readings():
    from gbench import harness

    ctx = context(small_cell("shgn-dblp.train"))
    return harness.driver("hgnn_train").calibrate(ctx)


@pytest.fixture(scope="module")
def granite_readings():
    from gbench import harness

    ctx = context(small_cell("granite-moe-1b-a400m.train_4k"))
    return harness.driver("lm_train").calibrate(ctx)


def test_shgn_reference_composes_the_ports_semantic_graphs(shgn_readings):
    assert shgn_readings["sgb_edges_diff"] == 0


@pytest.mark.parametrize("number,limit", [("loss_gap", 1e-6), ("grad_norm_gap", 1e-5),
                                          ("median_grad_gap", 1e-6),
                                          ("update_norm_gap", 1e-3)])
def test_shgn_reference_follows_the_port(shgn_readings, number, limit):
    # float32 on both sides, summed in other orders
    assert shgn_readings["program"][number] <= limit


def test_shgn_tf32_control_reads_above_the_port(shgn_readings):
    prog, ctrl = shgn_readings["program"], shgn_readings["control:tf32"]
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in prog) >= 3


@pytest.mark.parametrize("number,limit", [("loss_gap", 1e-3), ("grad_norm_gap", 1e-2),
                                          ("update_norm_gap", 1e-2)])
def test_granite_reference_follows_the_port(granite_readings, number, limit):
    # the port computes in bf16, the reference in float32
    assert granite_readings["program"][number] <= limit


def test_granite_fp8_control_reads_above_the_port(granite_readings):
    prog, ctrl = granite_readings["program"], granite_readings["control:fp8"]
    assert ctrl["grad_norm_gap"] >= 3 * prog["grad_norm_gap"]


def test_granite_prefill_reference_follows_the_port():
    from gbench import harness

    out = harness.driver("lm_prefill").calibrate(context(small_cell(
        "granite-moe-1b-a400m.prefill_2k")))
    assert out["program"]["logit_max_err"] <= 0.2
    assert out["control:fp8"]["logit_max_err"] >= 3 * out["program"]["logit_max_err"]



def test_shgn_reference_repeats_bit_for_bit():
    # the check's yardstick may not move between runs: its own round-off
    # once read a median-leaf change gap of 1.6e-4 against itself on the card
    import torch

    from gbench import hgnn_inputs
    from reference import hgnn_ref

    cell = small_cell("shgn-dblp.train")
    inp = hgnn_inputs.make(cell.config, 2 ** 31 + 5, "cpu")
    target = cell.config["model"]["target_type"]
    runs = [hgnn_ref.train(inp.params, inp.features[target], inp.semantic, target, inp.labels,
                           inp.masks["train"], steps=2, lr=cell.spec["lr"])
            for _ in range(2)]
    assert runs[0]["losses"] == runs[1]["losses"]
    for a, b in zip(runs[0]["grads"] + runs[0]["params"], runs[1]["grads"] + runs[1]["params"]):
        assert torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()
