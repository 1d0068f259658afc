"""Shared helpers for the port's parity tests (``test_torch_*.py``): build
matching reference/port configs, draw the reference's parameters once per
process (:func:`reference_model`) and carry reference arrays into the port
through :mod:`repro_torch.bridge`."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.core.sparse_format import BlockSparseWeight as JaxSparse
from repro.distributed import NULL_CTX
from repro.distributed.convert_plan import convert_concrete as jax_convert
from repro.models import lm as jlm

from repro_torch import bridge
from repro_torch.configs import get_config as torch_config

# one intra-op torch thread: the port's tests run tiny tensors, which many
# threads only slow down, and the suite's workers share the cores
torch.set_num_threads(1)


def configs(dtype="float32", **kw):
    """(reference cfg, port cfg): reduced qwen3-0.6b with the same edits."""
    kw = dict(compute_dtype=dtype, param_dtype=dtype, **kw)
    return (dataclasses.replace(jax_config("qwen3-0.6b").reduced(), **kw),
            dataclasses.replace(torch_config("qwen3-0.6b").reduced(), **kw))


def to_numpy(tree):
    """Reference pytree -> nested dicts of numpy arrays (the bridge input)."""
    if isinstance(tree, JaxSparse):
        return {"bitmap": np.asarray(tree.bitmap),
                "values": np.asarray(tree.values),
                "scale": None if tree.scale is None else np.asarray(tree.scale),
                "shape": tree.shape, "block": tree.block,
                "packed4": tree.packed4}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def sparse_params(jcfg, tcfg, seed=0):
    """Reference init + reference packing (one jitted program), bridged:
    (jax params, port params) holding the same bytes."""
    jparams = jax.jit(lambda key: jax_convert(
        jlm.init_params(jcfg, key), jlm.model_specs(jcfg), jcfg,
        NULL_CTX))(jax.random.PRNGKey(seed))
    return jparams, bridge.params_from_numpy(to_numpy(jparams), tcfg, "cpu")


_DRAWS = {}
# fields of a config that its parameters do not depend on
SERVING_FIELDS = {"kv_tail", "full_attn_max"}


def reference_model(name, dtype="float32", seed=3, **serving):
    """(reference cfg, port cfg, reference params, port params) of ``name``
    reduced, at ``dtype`` (compute and parameters), with the serving fields
    ``serving`` replaced: the reference's dense draw (one jitted
    ``init_params`` at f32; another dtype casts that draw to the dtypes its
    own ``init_params`` gives each leaf) bridged.  Drawn once per process
    for each name, dtype and seed, so the tests and test modules of one
    process share it; a test must not write into it."""
    assert set(serving) <= SERVING_FIELDS, serving
    kw = dict(compute_dtype=dtype, param_dtype=dtype, **serving)
    jcfg = dataclasses.replace(jax_config(name).reduced(), **kw)
    tcfg = dataclasses.replace(torch_config(name).reduced(), **kw)
    key = (name, dtype, seed)
    if key not in _DRAWS:
        if dtype == "float32":
            jp = jax.jit(lambda k: jlm.init_params(jcfg, k))(
                jax.random.PRNGKey(seed))
        else:
            jp32 = reference_model(name, "float32", seed)[2]
            like = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                                  jax.random.PRNGKey(seed))
            jp = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype),
                                        jp32, like)
        _DRAWS[key] = (jp, bridge.params_from_numpy(to_numpy(jp), tcfg,
                                                    "cpu"))
    return (jcfg, tcfg, *_DRAWS[key])


def rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def as_np(t):
    """torch or jax array -> float64 numpy for comparisons."""
    if hasattr(t, "detach"):
        return t.detach().to("cpu").double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)
