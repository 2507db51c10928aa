"""The serve and train CLIs of the port's non-dense families on the CPU
(``--smoke --device cpu``) against the reference's CLIs, for every arch
of the moe, ssm, hybrid, vlm and audio families:

- ``serve_lm``: the reference's eager init bits and ``randint`` prompts,
  the zero context of the vlm and audio, teacher-forced logits within the
  bf16 bound and the greedy tokens (``torch_lm_families.check_serve_cli``);
- ``launch.train`` for three steps: the per-step losses within
  CLI_LOSS_ATOL (the same init bits, graph and walks; bf16 arithmetic) and
  the same verdict.  The reference's CLI feeds no context: its vlm runs the
  cross layers as causal self-attention (RoPE, no qk-norm) and the port
  does alike; its audio model fails at the first step on the missing
  encoder input (``None.dtype``) and the port fails there too, naming it.
  The reference's zamba2 runs under ``reference_safe_decay``: as it stands
  its SSD gradient is NaN at these 32-token windows, so its losses are NaN
  from step 1 on (``test_torch_ssm.py``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import torch_lm_families as fam
from test_torch_reference import ref  # noqa: F401  (fixture)

OTHERS = ("phi3_5_moe_42b", "mixtral_8x22b", "falcon_mamba_7b", "zamba2_2_7b", "llama_3_2_vision_90b",
          "whisper_base")
TRAIN_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def lm(ref):
    return fam.reference_lm(ref)


@pytest.mark.parametrize("arch", OTHERS)
def test_serve_cli_follows_the_reference(lm, capsys, arch):
    fam.check_serve_cli(lm, arch, capsys)


@pytest.mark.parametrize("arch", OTHERS)
def test_train_cli_follows_the_reference(lm, tmp_path, monkeypatch, capsys, arch):
    hybrid = arch == "zamba2_2_7b"
    with fam.reference_safe_decay(lm) if hybrid else contextlib.nullcontext():
        outcomes, (r, p) = fam.run_train_clis(arch, TRAIN_STEPS, tmp_path, monkeypatch)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith(("[data]", "[model]"))]
    assert len(lines) == 4 and lines[:2] == lines[2:]  # the same graph and model lines
    if arch == "whisper_base":
        assert isinstance(outcomes[0], AttributeError) and "dtype" in str(outcomes[0])
        assert isinstance(outcomes[1], ValueError) and "needs a context" in str(outcomes[1])
        assert r == p == []  # no step ran in either
        return
    err = float(np.abs(np.array(r[0]) - np.array(p[0])).max())
    print(f"{arch} train CLI losses: reference {r[0]}, port {p[0]}; max diff {err} (bound {fam.CLI_LOSS_ATOL}); "
          f"verdicts {outcomes}")
    assert outcomes[0] == outcomes[1] and len(p[0]) == TRAIN_STEPS and err <= fam.CLI_LOSS_ATOL
