"""The port's accuracy-study tool against the JAX package's, with every
subprocess stubbed out.

Both tools run under the same argv (the port's with ``--device cpu``)
and the same recording fake of ``sh`` (``tests/test_accuracy_study.py``'s):
each port command must be the JAX one with ``vit_search_tpu`` replaced by
``vit_search_torch``, and ``--device cpu`` appended to the ``cli.train`` and
``cli.evo_search`` commands only; the two ``study_summary.json`` files must
be equal (the random control drawn by each package's generator from
``default_rng(12345)``, the MACs by each package's estimator).
"""

import json
import os
import shutil

import pytest

from vit_search_torch.tools import accuracy_study as torch_study
from vit_search_tpu.tools import accuracy_study as jax_study

from test_accuracy_study import WINNER_DEF

WORST_DEF = WINNER_DEF.replace("(2, 896, 100))", "(2, 832, 100))")
CURVE_LINE = json.dumps({"epoch": 0, "train_loss": 4.0, "test_acc1": 10.0,
                         "test_acc5": 30.0}) + "\n"
CLI_MODULES = ("cli.train", "cli.evo_search")


def recording_sh(cmds, history):
    """``tests/test_accuracy_study.py``'s fake: the search writes
    ``history.csv`` (rows ``history``) and ``summary.txt``, a training run
    one epoch of ``log.txt``."""
    def fake_sh(cmd, log_path=None):
        cmds.append(list(cmd))
        joined = " ".join(cmd)
        if "cli.evo_search" in joined:
            out = cmd[cmd.index("--output_dir") + 1]
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "history.csv"), "w") as f:
                f.write("rank,score,network_def\n" + "".join(
                    f'{i},{score},"{net}"\n' for i, (score, net) in enumerate(history)))
            with open(os.path.join(out, "summary.txt"), "w") as f:
                f.write("iter 0: score=5.3\n")
        elif "cli.train" in joined and "--network-def" in joined:
            out = cmd[cmd.index("--output_dir") + 1]
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "log.txt"), "w") as f:
                f.write(CURVE_LINE)
    return fake_sh


def prior_finetune_artifacts(root):
    """``tests/test_accuracy_study.py::test_study_stage_selection``'s
    artifacts of earlier stages."""
    (root / "search").mkdir()
    (root / "search" / "history.csv").write_text(
        'rank,score,network_def\n0,5.3,"%s"\n' % WINNER_DEF)
    (root / "search" / "summary.txt").write_text("iter 0: score=5.3\n")
    (root / "finetune").mkdir()
    (root / "finetune" / "log.txt").write_text(
        json.dumps({"epoch": 0, "train_loss": 3.0, "test_acc1": 12.0,
                    "test_acc5": 33.0}) + "\n")
    (root / "study_summary.json").write_text(
        json.dumps({"winner_final_acc1": 10.0, "random_final_acc1": 9.0}))


# the JAX tests' cases: (argv after --root, search history, prior artifacts)
CASES = {
    "input_size_112": (["--skip-generate", "--input-size", "112"], [(5.3, WINNER_DEF)], None),
    "input_size_224": (["--skip-generate", "--input-size", "224"], [(5.3, WINNER_DEF)], None),
    "controls_random_worst": (["--skip-generate", "--controls", "random,worst",
                               "--stages", "supernet,search,retrain"],
                              [(5.3, WINNER_DEF), (2.0, WORST_DEF)], None),
    "stages_finetune_eval": (["--stages", "finetune,eval"], [(5.3, WINNER_DEF)],
                             prior_finetune_artifacts),
}


def run_study(module, root, argv, history, prior, monkeypatch):
    """Run ``module.main`` from a clean ``root``; its commands and summary."""
    if root.exists():
        shutil.rmtree(root)
    root.mkdir()
    if prior:
        prior(root)
    cmds = []
    monkeypatch.setattr(module, "sh", recording_sh(cmds, history))
    monkeypatch.setattr("sys.argv", ["accuracy_study", "--root", str(root), *argv])
    module.main()
    with open(root / "study_summary.json") as f:
        return cmds, json.load(f)


def port_command(jax_cmd, device):
    cmd = [arg.replace("vit_search_tpu", "vit_search_torch") for arg in jax_cmd]
    if any(f"vit_search_torch.{m}" in cmd for m in CLI_MODULES):
        cmd += ["--device", device]
    return cmd


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_study_equals_the_jax_study(case, tmp_path, monkeypatch):
    argv, history, prior = CASES[case]
    root = tmp_path / "study"
    jax_cmds, jax_summary = run_study(jax_study, root, argv, history, prior, monkeypatch)
    cmds, summary = run_study(torch_study, root, argv + ["--device", "cpu"], history, prior,
                               monkeypatch)
    assert jax_cmds, "the JAX study ran no command"
    assert cmds == [port_command(c, "cpu") for c in jax_cmds]
    assert not any("vit_search_tpu" in arg for cmd in cmds for arg in cmd)
    assert summary == jax_summary
    # the three cases with a retrain stage draw the random control
    assert ("random_def" in summary) == (case != "stages_finetune_eval")


def test_port_study_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` every CLI command asks for the card; the data
    commands take no device."""
    argv, history, _ = CASES["input_size_112"]
    cmds, _ = run_study(torch_study, tmp_path / "study",
                         [a for a in argv if a != "--skip-generate"], history, None, monkeypatch)
    cli = [c for c in cmds if any(f"vit_search_torch.{m}" in c for m in CLI_MODULES)]
    data = [c for c in cmds if c not in cli]
    assert len(cli) == 6 and len(data) == 2
    assert all(c[-2:] == ["--device", "cuda"] for c in cli)
    assert not any("--device" in c for c in data)


def test_study_timing_reads_each_stage():
    """``tools.study_timing`` on the shape of the study's output: each
    stage's ``+ command`` and ``[Ns]``, the epochs' last step lines and
    throughput lines (the port's CLI's formats)."""
    from vit_search_torch.tools import study_timing

    text = "\n".join([
        "+ python -m vit_search_torch.tools.make_synthfolder /r/data --classes 4",
        "  [3s]",
        "+ python -m vit_search_torch.cli.train --model m --output_dir /r/supernet --device cpu",
        "Epoch: [0] [0/3]  eta: 0:00:02  lr: 0.000000  time: 1.0229  data: 0.1014",
        "Epoch: [0] [2/3]  eta: 0:00:00  lr: 0.000001  loss: 2.75 (2.85)  time: 0.5000  "
        "data: 0.4000",
        "Epoch: [0] throughput: 16.0 imgs/s (3 steps, global batch 16)",
        "Test:  [0/1]  time: 0.3  data: 0.2",
        "  [15s]",
        "+ python -m vit_search_torch.cli.train --eval --resume /r/finetune/checkpoints/c",
        "  [9s]"])
    out = study_timing.parse(text)
    assert [s["stage"] for s in out["stages"]] == [
        "tools.make_synthfolder", "cli.train supernet", "cli.train --eval"]
    assert [s["seconds"] for s in out["stages"]] == [3, 15, 9] and out["seconds"] == 27
    # 3 steps of 16 at 16 imgs/s: 3 s, of which the steps at 0.5 s take 1.5
    assert out["stages"][1]["epochs"] == [{"steps": 3, "batch": 16, "step_s": 0.5,
                                          "data_s": 0.4, "imgs_per_s": 16.0,
                                          "loader_share": 0.5}]
