"""The plain reference against the program's own prefill and decode_step,
in float32 on the CPU, on tiny configurations of both families, with and
without dropped slots."""

import pytest
import torch

from bench import spec, traffic as tr, weights
from bench.reference import lm as ref
from bench.tests.conftest import tiny_config
from repro_torch.models import transformer as T


@pytest.mark.parametrize("family", ["dsmoe", "phi", "dense"])
@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_reference_matches_prefill_and_decode(family, capacity, cpu):
    conf = tiny_config(family, capacity=capacity)
    port, cfg = conf["port"], spec.lm_config(conf)
    params = weights.make_params(port, 5, cpu)
    prompts = tr.prompts({"batch": 3, "prompt_len": 12}, port["vocab"], 7, 0,
                         cpu)
    cache, logits = T.prefill(params, prompts, cfg, max_seq=16, device=cpu)
    served, out = [logits.argmax(-1)], [logits]
    for _ in range(3):
        cache, logits = T.decode_step(params, cache, served[-1].int(), cfg,
                                      device=cpu)
        served.append(logits.argmax(-1))
        out.append(logits)
    served = torch.stack(served, 1)
    seq = torch.cat([prompts, served[:, :3].int()], 1)
    hidden = ref.final_hidden(params, port, seq, 12, list(range(11, 15)))
    want = ref.head_logits(params, hidden.reshape(-1, hidden.shape[-1]))
    want = want.view(*hidden.shape[:2], -1)
    torch.testing.assert_close(torch.stack(out, 1).float(), want,
                               rtol=1e-4, atol=1e-4)
    assert float(ref.gaps(params, hidden, served).max()) == 0.0


def test_capacity_drops_slots_by_group(cpu):
    """The first slots of an expert within its group are kept, the rest
    dropped; each group has its own capacity."""
    c = {"n_experts": 2, "top_k": 1, "capacity_factor": 1.0}
    router = torch.tensor([[10.0, -10.0]])           # every token to expert 0
    x = torch.ones((6, 1))
    tok, exp, _ = ref.route(x, router, c, [4, 2])
    # groups of 4 and 2 tokens: C = int(1.0 * 4 / 2) = 2 and 1
    assert tok.tolist() == [0, 1, 4] and exp.tolist() == [0, 0, 0]


def test_fp8_control_rounds_operands():
    x = torch.tensor([[1.0, 0.3, -0.0123]])
    w = torch.eye(3)
    got = ref._mm(x, w, "fp8")
    assert not torch.equal(got, x)
    torch.testing.assert_close(got, x, rtol=0.07, atol=1e-3)


def test_reference_refuses_windowed_layers(cpu):
    conf = tiny_config("phi")
    port = dict(conf["port"], pattern=["local", "full"])
    params = weights.make_params(conf["port"], 1, cpu)
    with pytest.raises(ValueError, match="full"):
        ref.final_hidden(params, port, torch.zeros((1, 4), dtype=torch.int32),
                         4, [3])
