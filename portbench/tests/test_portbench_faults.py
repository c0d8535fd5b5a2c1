"""A whole run on the CPU (the rehearsal: no look for a card, a tiny
model) with the timed path broken underneath: ``correct`` comes out
false for each fault a serve cell can have.  The cells run on one chip,
so no exchange between chips can be left out."""
import pytest
import torch

import run as runmod
from harness import common

CELLS = [w["name"] for w in common.load_benchmark()["workloads"]]


def _run(cell, seed=5):
    line, checks, _ = runmod.main(
        ["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
         "--trace", "0", "--rehearse"])
    return line, checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line, _ = _run(cell)
    assert line["correct"] is True


def _state_unchanged(monkeypatch):
    """The step leaves the KV cache as it found it."""
    from repro_torch.serving import kvcache
    monkeypatch.setattr(kvcache, "write_token_kv",
                        lambda kv, layer, k, v, slots: kv)


def _token_altered(monkeypatch):
    """Each slot's chosen token is the one after its best."""
    from repro_torch.serving import engine
    forward = engine.ServeStep.forward

    def altered(self, *args):
        logits, kv = forward(self, *args)
        return torch.roll(logits, 1, dims=-1), kv
    monkeypatch.setattr(engine.ServeStep, "forward", altered)


def _half_the_batch_left_out(monkeypatch):
    """Every other slot's row is left out of the step and takes its even
    neighbour's logits."""
    from repro_torch.serving import engine
    forward = engine.ServeStep.forward

    def halved(self, *args):
        logits, kv = forward(self, *args)
        out = logits.clone()
        out[1::2] = logits[0::2][:out[1::2].shape[0]]
        return out, kv
    monkeypatch.setattr(engine.ServeStep, "forward", halved)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _token_altered,
                                   _half_the_batch_left_out])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line, checks = _run(cell)
    assert line["correct"] is False, checks
