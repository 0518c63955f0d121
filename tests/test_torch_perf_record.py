"""The port's pins (``p1_tpu_torch/hashx/perf_record.py``) against the JAX
package's ``p1_tpu/hashx/perf_record.py``.

The port keeps the reference's constant names, so every ``bench`` ratio
finds its counterpart, but one rename (``RECORDED_V5E_PALLAS_HPS`` is
``RECORDED_H100_CUDA_HPS``); its tolerances are the reference's policy;
every pin is a figure of this port's own chip runs, and its comment says
so by naming the card and its power limit.  The pure-Python rung's
figures that ``core/keys.py``'s forced-fallback warning names
(``core/_ed25519.py``) are held the same way.
"""

import pathlib
import re

import pytest

from p1_tpu.hashx import perf_record as ref
from p1_tpu_torch.core import _ed25519
from p1_tpu_torch.hashx import perf_record as port

RENAMES = {"RECORDED_V5E_PALLAS_HPS": "RECORDED_H100_CUDA_HPS"}


def _constants(module) -> dict:
    return {k: v for k, v in vars(module).items() if k.isupper() and not k.startswith("_")}


def _pin_comments(path: pathlib.Path, prefix: str = "RECORDED_") -> dict[str, str]:
    """Each ``RECORDED_*`` assignment's comment: the ``#:`` block above it
    (a group of pins right under one block shares it)."""
    out, block = {}, []
    for line in path.read_text().splitlines():
        if line.startswith("#:"):
            block = block + [line] if block and block[-1].startswith("#:") else [line]
        elif not line.strip():
            block = []
        elif m := re.match(rf"({prefix}\w+)\s*=", line):
            out[m.group(1)] = re.sub(r"\s+", " ", " ".join(b[2:] for b in block))
    return out


def test_names_are_the_references_but_the_rename():
    assert set(_constants(port)) == {RENAMES.get(k, k) for k in _constants(ref)}


@pytest.mark.parametrize("name", sorted(k for k in _constants(ref) if not k.startswith("RECORDED_")))
def test_tolerances_are_the_references(name):
    assert getattr(port, name) == getattr(ref, name)


@pytest.mark.parametrize("name", sorted(_constants(port)))
def test_every_constant_is_sane(name):
    value = getattr(port, name)
    assert value > 0, name
    if name.endswith("_FRACTION"):
        assert value < 1
    if name.endswith("_FACTOR"):
        assert value > 1


def test_every_pin_names_the_card():
    comments = _pin_comments(pathlib.Path(port.__file__))
    pins = {k for k in _constants(port) if k.startswith("RECORDED_")}
    assert set(comments) == pins
    for name, text in comments.items():
        assert "NVIDIA H100 80GB HBM3" in text and "700.00 W" in text, name


def test_no_pin_is_a_reference_figure():
    """A TPU's or the reference host's figure is never a port pin."""
    ref_values = {v for k, v in _constants(ref).items() if k.startswith("RECORDED_")}
    same = [k for k, v in _constants(port).items() if k.startswith("RECORDED_") and v in ref_values]
    assert same == ["RECORDED_WALLET_SUBS"]  # a session count bench sets, not a measurement


def test_fallback_rung_figures_are_the_cards_hosts():
    comments = _pin_comments(pathlib.Path(_ed25519.__file__))
    assert set(comments) == {"RECORDED_SERIAL_MS", "RECORDED_BATCH_MS"}
    for name, text in comments.items():
        assert "NVIDIA H100 80GB HBM3" in text and "700.00 W" in text and "card's host" in text, name
        assert getattr(_ed25519, name) > 0
