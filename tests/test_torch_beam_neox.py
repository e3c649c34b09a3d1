"""Beam search on a tiny GPT-NeoX (RoPE, untied head, biases) Flamingo
against the JAX package on the CPU, as tests/test_torch_beam_sample.py
does for MPT: tokens exactly equal to JAX `flamingo_generate(num_beams=3)`,
full and left-padded masks, eos set and None, length_penalty 0 and 1, on
the einsum route and under the fused hooks (K1 + K6 + K2 per layer).
"""

import pytest
from test_torch_beam_sample import beams_equal_jax, fused, make_family  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def neox():
    return make_family("gptneox")


# left-pad columns, eos (None or a token the beams emit), length_penalty, route
CASES = {
    "pad_eos_lp1": (3, 65, 1.0, "einsum"),
    "full_noeos_lp0": (0, None, 0.0, "einsum"),
    "pad_eos_lp0_fused": (3, 65, 0.0, "fused"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_tokens_equal_jax(neox, request, case):
    cols, eos, lp, route = CASES[case]
    if route == "fused":
        request.getfixturevalue("fused")
    beams_equal_jax(neox, "gptneox", cols, eos, lp)
