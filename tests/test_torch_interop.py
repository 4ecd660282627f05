"""Parameters cross between the JAX package and the PyTorch port through
the reference's flat checkpoint format (``repro.checkpoint.ckpt._flatten``
keys): JAX → numpy → port → numpy must be bitwise, and the port's
parameter names must map one-to-one onto the reference's keys."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402


def _jax_flat(cfg, seed=0):
    flat, _ = _flatten(JaxLM(cfg).init(jax.random.PRNGKey(seed)))
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def _cfgs(arch, **kw):
    """(jax cfg, port cfg) pair; ``kw`` goes to ``reduced`` when given."""
    if kw:
        return (jax_reduced(jax_get_config(arch), **kw),
                reduced(get_config(arch), **kw))
    return jax_get_config(arch), get_config(arch)


@pytest.mark.parametrize("arch,kw", [
    ("lm-tiny", {}),
    ("llama3.2-3b", dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                         vocab=128, repeats=3)),
])
def test_params_round_trip_bitwise(arch, kw):
    jcfg, pcfg = _cfgs(arch, **kw)
    flat = _jax_flat(jcfg)
    lm = interop.params_from_numpy(flat, pcfg, "cpu")
    back = interop.params_to_numpy(lm)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("arch,kw", [
    ("lm-tiny", {}),
    ("llama3.2-3b", dict(repeats=2)),
])
def test_port_names_map_onto_flatten_keys(arch, kw):
    jcfg, pcfg = _cfgs(arch, **kw)
    flat = _jax_flat(jcfg)
    names = [n for n, _ in LM(pcfg, "cpu").named_parameters()]
    assert {interop.jax_key(n) for n in names} == set(flat)
    # one port tensor per (key, layer): the stacked axis splits exactly
    per_key = {}
    for n in names:
        per_key[interop.jax_key(n)] = per_key.get(interop.jax_key(n), 0) + 1
    for k, v in flat.items():
        assert per_key[k] == (v.shape[0] if "/stacked/" in k else 1), k


def test_bf16_leaves_cross_as_f32_and_cast_back():
    jcfg, pcfg = _cfgs("llama3.2-3b", repeats=2)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    flat = _jax_flat(jcfg)
    lm = interop.params_from_numpy(flat, pcfg, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in lm.parameters())
    back = interop.params_to_numpy(lm)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_load_rejects_missing_and_misshapen_keys():
    jcfg, pcfg = _cfgs("lm-tiny")
    flat = _jax_flat(jcfg)
    lm = LM(pcfg, "cpu")
    with pytest.raises(KeyError, match="missing"):
        interop.load_params(lm, {k: v for k, v in flat.items()
                                 if k != "embed"})
    bad = dict(flat, embed=flat["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        interop.load_params(lm, bad)
