"""The plain reference agrees with the port at smoke size on the CPU:
logits of the same weights and tokens in float32, and greedy serving in
bf16 within the gap the check allows."""
import numpy as np
import pytest
import torch

from portbench import check, spec
from portbench.conftest import TINY_DENSE, TINY_MOE
from portbench.reference.qwen3 import Reference
from portbench.weights import draw_weights


@pytest.mark.parametrize("config", [TINY_DENSE, TINY_MOE],
                         ids=["dense", "moe"])
def test_reference_matches_the_port_f32(config):
    from repro_torch.models.transformer import forward
    c = dict(config, torch_dtype="float32")
    arch = spec.architecture(c)
    s = arch.shapes(c, "tiny")
    host = draw_weights(arch.leaves(s), 2 ** 33 + 5, "cpu")
    toks = np.random.default_rng(0).integers(0, s.vocab, size=(2, 37))
    z, _ = forward(host, arch.port_config(c, s),
                   {"tokens": torch.as_tensor(toks)})
    ref = Reference(s, host, "cpu").logits([toks[0], toks[1]],
                                           [np.arange(37)] * 2)
    for i in range(2):
        torch.testing.assert_close(z[i], ref[i], rtol=1e-5, atol=2e-5)


def test_control_computes_every_layer_product_in_fp8():
    arch = spec.architecture(TINY_DENSE)
    s = arch.shapes(TINY_DENSE, "tiny")
    host = draw_weights(arch.leaves(s), 11, "cpu")
    ref, ctl = Reference(s, host, "cpu"), Reference(s, host, "cpu", "fp8")
    w, wc = ref._layer(0), ctl._layer(0)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        err = (w[k] - wc[k]).abs().max() / w[k].abs().max()
        assert 0 < float(err) < 2 ** -3
    for k in ("ln1", "ln2", "q_norm", "k_norm"):
        assert torch.equal(w[k], wc[k])
    a = torch.randn(5, s.d)
    # the control's activation is rounded per row as well
    assert torch.equal(ref._mm(a, w["wq"]), a @ w["wq"])
    rounded = ctl._mm(a, wc["wq"])
    assert not torch.equal(rounded, a @ wc["wq"])
    err = (rounded - a @ wc["wq"]).abs().max() / (a @ wc["wq"]).abs().max()
    assert float(err) < 2 ** -3


def test_longest_request_is_always_sampled():
    class R:
        def __init__(self, t, n):
            self.prompt, self.generated = [0] * t, [1] * n
    done = [R(10, 3), R(50, 9), R(20, 4), R(30, 2), R(12, 5)]
    for seed in (0, 1, 2 ** 40):
        got = check.sample_requests(done, 3, seed)
        assert got[0] is done[1] and len(got) == 3
        assert len({id(r) for r in got}) == 3
    assert check.sample_requests(done, 3, 7) == \
        check.sample_requests(done, 3, 7)
