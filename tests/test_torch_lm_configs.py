"""The port's LM zoo configs (``repro_torch.configs``) against the JAX
package's: every arch and its ``reduced()`` variant equal field for field,
the derived properties equal layer by layer, and the transformer's unit
descriptors (``_decoder_descs``) equal."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def test_registry_matches_jax():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("llama-0b")


@pytest.mark.parametrize("arch", jconfigs.list_archs())
@pytest.mark.parametrize("variant", ["published", "reduced"])
def test_config_matches_jax_field_for_field(arch, variant):
    ours, want = tconfigs.get_config(arch), jconfigs.get_config(arch)
    if variant == "reduced":
        ours, want = tconfigs.reduced(ours), jconfigs.reduced(want)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(want)]
    assert ours.resolved_head_dim == want.resolved_head_dim
    assert ours.is_attention_free == want.is_attention_free
    assert ours.supports_long_decode() == want.supports_long_decode()
    layers = range(ours.num_layers)
    assert [ours.attn_layer(i) for i in layers] == [want.attn_layer(i) for i in layers]
    assert [ours.moe_layer(i) for i in layers] == [want.moe_layer(i) for i in layers]
    descs, units = ttf._decoder_descs(ours)
    jdescs, junits = jtf._decoder_descs(want)
    assert units == junits
    assert [dataclasses.asdict(d) for d in descs] == [dataclasses.asdict(d) for d in jdescs]


def test_replace_and_reduced_keywords_match_jax():
    ours = tconfigs.reduced(tconfigs.get_config("jamba-1.5-large-398b"), layers=3, d_model=128,
                            vocab=256).replace(sliding_window=32)
    want = jconfigs.reduced(jconfigs.get_config("jamba-1.5-large-398b"), layers=3, d_model=128,
                            vocab=256).replace(sliding_window=32)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.num_layers = 4
