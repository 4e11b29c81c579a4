"""Port parity: the architecture registry against the reference's.

Every id the port registers returns the reference's config field for field,
and its reduced config too (the dense LMs: h2o-danube-3-4b, gemma3-12b,
granite-3-8b, starcoder2-7b); ``lm_archs()`` is the reference's list
restricted to the ported ids; an id that is not ported raises KeyError.
"""
import dataclasses

import pytest

from repro import configs as jconfigs

from repro_torch import configs as tconfigs


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_registered_configs_match_reference(arch):
    got, want = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", tconfigs.lm_archs())
def test_reduced_configs_match_reference(arch):
    got, want = tconfigs.get_reduced(arch), jconfigs.get_reduced(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_dense_configs_are_registered():
    assert {"h2o-danube-3-4b", "gemma3-12b",
            "starcoder2-7b"} <= set(tconfigs.lm_archs())


def test_paper_stream_is_registered():
    from repro_torch.configs import paper_stream
    assert tconfigs.get_config("paper-stream") is paper_stream.CONFIG
    assert tconfigs.get_config("paper-stream").array_elems == 10_000_000


def test_lm_archs_is_the_reference_list_restricted_to_the_port():
    ported = set(tconfigs.ARCH_IDS)
    assert tconfigs.lm_archs() == [a for a in jconfigs.lm_archs()
                                   if a in ported]
    assert "paper-stream" not in tconfigs.lm_archs()
    assert set(tconfigs.lm_archs()) | {"paper-stream"} == ported


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-125m",
                                  "no-such-arch"])
def test_unported_ids_raise_key_error(arch):
    with pytest.raises(KeyError, match="not ported"):
        tconfigs.get_config(arch)


def test_paper_stream_has_no_reduced_config():
    """As in the reference, ``get_reduced`` needs an LM: the case study has
    no layer pattern, and both raise."""
    for registry in (jconfigs, tconfigs):
        with pytest.raises(AttributeError, match="layer_pattern"):
            registry.get_reduced("paper-stream")
