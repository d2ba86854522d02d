"""`python -m vsrcic_tpu_torch.tools.dryrun_multigpu N --platform cpu`, the
counterpart of `__graft_entry__.dryrun_multichip`: on two gloo ranks on the
CPU, one XE step, one SCST step on a batch of 3, both planner trainers on
5 groups and 7 pairs and the sharded eval pipeline on 3 jobs with an
ambiguous role run, every loss finite and every rank ending with the same
parameters; a device list that is not one device per rank is refused."""
import pytest

from vsrcic_tpu_torch.tools import dryrun_multigpu


def test_dryrun_on_two_cpu_ranks(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert dryrun_multigpu.main(["2", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("XE loss", "SCST loss", "(batch 3) OK",
                 "S-SSP", "(5 groups)", "(7 pairs) OK",
                 "sharded eval pipeline (3, 6) OK"):
        assert line in out, line
    assert "dryrun_multigpu(2, gloo)" in out


def test_dryrun_wants_one_device_per_rank():
    with pytest.raises(SystemExit):
        dryrun_multigpu.main(["2", "--devices", "cpu"])
