"""The port's ``render_results`` against the JAX package's, in-process.

The summaries of ``tests/test_render_results.py`` render through both
packages; the markdown must be equal but for the lines that name the
platform (the JAX package's TPU prose and reproduce line, the port's
NVIDIA H100 and ``vit_search_torch.tools.accuracy_study``), and the exact
Kendall p-value must be equal on every ``(n, C, D)`` up to n = 8.
"""

import difflib
import json

import pytest

from vit_search_torch.tools import render_results as torch_render
from vit_search_tpu.tools import render_results as jax_render

from test_render_results import BASE, CURVE

# the JAX package's lines that name its platform, and what the port says
JAX_PLATFORM_LINES = [
    "pipeline).  Everything below ran through the real CLIs on the TPU with the",
    "Reproduce: `python -m vit_search_tpu.tools.accuracy_study --root <dir>`",
    "(one v5e chip; wall-clock dominated by the host input pipeline on this",
    "1-CPU-core dev box).",
]
PORT_PLATFORM_LINES = [
    "pipeline).  Everything below ran through the real CLIs on an NVIDIA H100 with the",
    "Reproduce: `python -m vit_search_torch.tools.accuracy_study --root <dir>`",
    "(one NVIDIA H100; `--device cpu` runs it on the CPU).",
]


def _controls(*tags):
    return {k: v for tag in tags for k, v in {
        f"{tag}_def": "((3,))", f"{tag}_mac": 1_750_000_000, f"{tag}_curve": CURVE,
        f"{tag}_final_acc1": 25.0}.items()}


# tests/test_render_results.py's summaries
SUMMARIES = {
    "minimal": BASE,
    "controls_finetune_eval": {**BASE, **_controls("random", "worst"), "finetune_size": 280,
                               "finetune_curve": CURVE, "eval_only": "{'acc1': 30.0}"},
    "seed_table_and_rankcorr": {
        **BASE, **_controls("random"),
        "winner_final_acc1_by_seed": {"0": 30.0, "1": 31.0, "2": 29.5},
        "random_final_acc1_by_seed": {"0": 25.0, "1": 24.0, "2": 26.0},
        "rankcorr": {"entries": [{"history_rank": 0, "fitness": 12.0, "mac": 1_700_000_000,
                                  "retrained_acc1": 31.0, "network_def": "((2,))"},
                                 {"history_rank": 9, "fitness": 8.0, "mac": 1_650_000_000,
                                  "retrained_acc1": 27.0, "network_def": "((4,))"}],
                     "kendall_tau": 1.0, "concordant": 1, "discordant": 0}},
    "seed_table_without_random": {**BASE, "winner_final_acc1_by_seed": {"0": 30.0, "1": 31.0}},
}


def render(module, main_args, tmp_path, summary, name, monkeypatch):
    src, out = tmp_path / f"{name}.json", tmp_path / f"{name}.md"
    src.write_text(json.dumps(summary))
    if main_args:
        module.main([str(src), str(out)])
    else:
        monkeypatch.setattr("sys.argv", ["render_results", str(src), str(out)])
        module.main()
    return out.read_text().splitlines()


@pytest.mark.parametrize("name", sorted(SUMMARIES))
def test_port_renders_the_jax_markdown(name, tmp_path, monkeypatch):
    summary = SUMMARIES[name]
    want = render(jax_render, False, tmp_path, summary, "jax", monkeypatch)
    got = render(torch_render, True, tmp_path, summary, "torch", monkeypatch)
    removed, added = [], []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, want, got,
                                                      autojunk=False).get_opcodes():
        if op != "equal":
            removed += want[i1:i2]
            added += got[j1:j2]
    assert removed == JAX_PLATFORM_LINES
    assert added == PORT_PLATFORM_LINES
    assert not any("TPU" in line or "v5e" in line for line in got)


def test_kendall_exact_p_equals_the_jax_package():
    for n in range(1, 9):
        pairs = n * (n - 1) // 2
        for concordant in range(pairs + 1):
            for discordant in range(pairs + 1 - concordant):
                assert (torch_render.kendall_exact_one_sided_p(n, concordant, discordant)
                        == jax_render.kendall_exact_one_sided_p(n, concordant, discordant)), \
                    (n, concordant, discordant)
    assert abs(torch_render.kendall_exact_one_sided_p(8, 20, 8) - 0.089435) < 5e-6


@pytest.mark.parametrize("values", [[], [1.0], [3.0, 1.0, 2.0, 2.0], list(range(80))])
def test_spark_and_table_equal_the_jax_package(values):
    assert torch_render.spark(values) == jax_render.spark(values)
    curve = [{"epoch": i, "train_loss": v, "test_acc1": v * 2} for i, v in enumerate(values)]
    keys = ["train_loss", "test_acc1", "test_acc5"]
    assert torch_render.table(curve, keys) == jax_render.table(curve, keys)
