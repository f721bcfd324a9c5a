"""Phase 17 of ``chip_smoke.py`` (`repro_torch.smoke_dryrun`) rehearsed on
the CPU: qwen1.5-0.5b's smoke config with the merged embedding backward,
traced at world 1 on fake CPU tensors and run for real as a placed
(DTensor) train step over a world-1 gloo group (the first loss equals
`LM.loss` bit for bit, the params stay finite), beside the production
cell qwen1.5-0.5b x decode_32k dry-run on a fake world of 256 in a
subprocess (fake tensors on the CPU) and the sixteen mini cells on fake
(2, 2, 2) worlds in subprocesses beside it (each traces, shows the
collective kind named and JAX's argument bytes, the six gated cells'
temp bytes and the four's largest storage within their limits).  The card-only gates (the
arguments' bytes against the allocator's, the kernels' launches) are the
card's."""
import pytest
import torch

from repro_torch import smoke_dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_phase_17_rehearsal_on_the_cpu(capsys):
    out = smoke_dryrun.dryrun_phase("cpu", "cpu rehearsal", smoke=True)
    real, mem = out["real"], out["dry"]["memory"]
    assert real["bit_identical"] and real["finite"] and real["dtensor"] == "DTensor"
    assert mem["argument_size_in_bytes"] > 0 and mem["alias_size_in_bytes"] > 0
    assert out["dry"]["roofline"]["flops_per_device"] > 0
    row = out["cell"]["row"]
    assert row["status"] == "ok" and row["n_devices"] == 256
    assert row["memory"]["alias_bytes_per_device"] > 0
    printed = capsys.readouterr().out
    assert "dryrun production cell" in printed and "bit identical True" in printed
    assert [r["status"] for r in out["mini"]] == ["ok"] * len(smoke_dryrun.MINI_CELLS)
    assert printed.count("dryrun mini cell") == len(smoke_dryrun.MINI_CELLS)
    assert smoke_dryrun.check_mini(out["mini"]) == []
    assert smoke_dryrun.check(real, mem, on_card=False) == []
