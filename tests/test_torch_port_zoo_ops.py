"""The zoo's ops in the port (aread_tpu_torch/ops/mlp.py ``GateNN`` and
BatchNorm's ``tied_affine`` / ``scale_mod`` / ``bias_mod``;
aread_tpu_torch/ops/cross.py ``CrossNetV2`` and ``CrossNetMix``;
aread_tpu_torch/ops/fm.py ``InnerProductNetwork``, ``OuterProductNetwork``
with each kernel type, ``AttentionalFactorizationMachine``,
``CompressedInteractionNetwork``, ``AnovaKernel``) against the flax
modules of aread_tpu/ops, from the same weights (carried by
aread_tpu_torch/convert.py) on the same seed-made inputs: the output, the
gradient of a fixed weighted sum of it for every parameter and every
input, and BatchNorm's running statistics, in eval and in train (a masked
batch). Also ops/embedding.py's unpooled ``FeaturesEmbedding(method=None)``
and ``FeaturesLinear(use_bias=False)`` against theirs, and the FM ops'
own draws against flax's initializers. Tolerance atol 1e-5: f32 products
summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.ops.cross import CrossNetMix as JCrossNetMix
from aread_tpu.ops.cross import CrossNetV2 as JCrossNetV2
from aread_tpu.ops import embedding as jemb
from aread_tpu.ops import fm as jfm
from aread_tpu.ops.mlp import BatchNorm as JBatchNorm
from aread_tpu.ops.mlp import GateNN as JGateNN
from aread_tpu_torch.convert import convert_variables, flatten
from aread_tpu_torch.ops import fm
from aread_tpu_torch.ops.cross import CrossNetMix, CrossNetV2
from aread_tpu_torch.ops.embedding import FeaturesEmbedding, FeaturesLinear
from aread_tpu_torch.ops.initializers import xavier_normal_init
from aread_tpu_torch.ops.mlp import BatchNorm, GateNN
from tests.test_torch_port_zoo import seeded_variables

B, T, D = 32, 3, 10
F = 5  # fields of the FM ops' [B, F, D] inputs


def _bn_inputs(rng):
    return {"x": rng.standard_normal((B, T, D)) * 2 + 1,
            "mask": (np.arange(B) < B - 5).astype(np.float32)}


def _bn_mod_inputs(rng):
    return {**_bn_inputs(rng), "scale_mod": rng.uniform(0.5, 1.5, (1, D)),
            "bias_mod": rng.uniform(-0.5, 0.5, (1, D))}


def _fields(rng):
    """[B, F, D] field embeddings at a scale that keeps the outputs and
    their gradients O(1), where atol 1e-5 measures f32 round-off (a
    gradient summed over the batch of products of unit normals is O(10)
    and carries round-off above 1e-5)."""
    return {"x": 0.5 * rng.standard_normal((B, F, D))}


def _few_fields(rng):
    """The CIN's bias gradients sum over every row and embedding column:
    8 rows of 3 columns keep them O(1) too."""
    return {"x": 0.5 * rng.standard_normal((8, F, 3))}


# name: (flax module, port module, inputs from a numpy generator, whether
# the module takes ``train``)
CASES = {
    "gatenn": (lambda: JGateNN(8, 12, 0.0),
               lambda: GateNN(D, 8, 12, 0.0),
               lambda rng: {"x": rng.standard_normal((B, D))}, True),
    "crossnet_v2": (lambda: JCrossNetV2(2), lambda: CrossNetV2(D, 2),
                    lambda rng: {"x": rng.standard_normal((B, D))}, False),
    "crossnet_mix": (lambda: JCrossNetMix(2, 4, 3),
                     lambda: CrossNetMix(D, 2, 4, 3),
                     lambda rng: {"x": rng.standard_normal((B, D))}, False),
    "bn_tied_affine": (lambda: JBatchNorm(tied_affine=True),
                       lambda: BatchNorm((T, D), tied_affine=True),
                       _bn_inputs, True),
    "bn_scale_mod": (lambda: JBatchNorm(), lambda: BatchNorm((T, D)),
                     _bn_mod_inputs, True),
    "ipnn": (jfm.InnerProductNetwork, fm.InnerProductNetwork, _fields, False),
    **{f"opnn_{k}": (lambda k=k: jfm.OuterProductNetwork(F, D, k),
                     lambda k=k: fm.OuterProductNetwork(F, D, k), _fields,
                     False) for k in ("mat", "vec", "num")},
    "afm": (lambda: jfm.AttentionalFactorizationMachine(6, (0.0, 0.0)),
            lambda: fm.AttentionalFactorizationMachine(D, 6, (0.0, 0.0)),
            _fields, True),
    "cin": (lambda: jfm.CompressedInteractionNetwork(F, (6, 4, 3)),
            lambda: fm.CompressedInteractionNetwork(F, (6, 4, 3)),
            _few_fields, False),
    "cin_no_split": (
        lambda: jfm.CompressedInteractionNetwork(F, (4, 3), split_half=False),
        lambda: fm.CompressedInteractionNetwork(F, (4, 3), split_half=False),
        _few_fields, False),
    "anova": (lambda: jfm.AnovaKernel(3), lambda: fm.AnovaKernel(3), _fields,
              False),
    "anova_vec": (lambda: jfm.AnovaKernel(2, reduce_sum=False),
                  lambda: fm.AnovaKernel(2, reduce_sum=False), _fields,
                  False),
}


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=1e-5, err_msg=name)


RUNS = [(c, t) for c, v in CASES.items() for t in ((False, True) if v[3]
                                                    else (False,))]


@pytest.mark.parametrize("case,train", RUNS, ids=[
    f"{c}-{'train' if t else 'eval'}" for c, t in RUNS])
def test_forward_and_gradients_match_flax(case, train):
    jfactory, tfactory, make_inputs, takes_train = CASES[case]
    rng = np.random.default_rng(0)
    inputs = {k: v.astype(np.float32) for k, v in make_inputs(rng).items()}
    diff_names = [k for k in inputs if k != "mask"]
    jm = jfactory()
    call_kw = {"train": train} if takes_train else {}
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = seeded_variables(jm, **jin, **call_kw)
    params = variables.get("params", {})
    stats = {k: v for k, v in variables.items() if k != "params"}
    out_shape = jax.eval_shape(lambda: jm.apply(variables, **jin, **call_kw,
                                                mutable=list(stats)))[0].shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def jloss(p, diff):
        out, new = jm.apply({"params": p, **stats}, **{**jin, **diff},
                            **call_kw, mutable=list(stats))
        return jnp.sum(out * w), (out, new)

    (_, (jout, jnew)), (jgp, jgin) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            params, {k: jin[k] for k in diff_names})

    tm = tfactory()
    sd = convert_variables(jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(
                               np.asarray, stats.get("batch_stats", {})), D)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    tin = {k: torch.tensor(v, requires_grad=k in diff_names)
           for k, v in inputs.items()}
    tout = tm(**tin, **call_kw)
    loss = torch.sum(tout * torch.tensor(w))
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values())
                                + [tin[k] for k in diff_names])
    _close(tout.detach().numpy(), jout, "output")
    want = flatten(jax.tree_util.tree_map(np.asarray, jgp))
    assert set(want) == {n.replace(".", "/") for n in named}
    for n, g in zip(named, grads):
        _close(g.numpy(), want[n.replace(".", "/")], f"d / d {n}")
    for k, g in zip(diff_names, grads[len(named):]):
        _close(g.numpy(), jgin[k], f"d / d {k}")
    if "batch_stats" in jnew:
        for path, v in flatten(jax.tree_util.tree_map(
                np.asarray, jnew["batch_stats"])).items():
            _close(tm.state_dict()[path.replace("/", ".")].numpy(), v, path)
            changed = not np.array_equal(v, np.asarray(flatten(
                stats["batch_stats"])[path]))
            assert changed == train, path


def test_tied_affine_shapes_and_xavier_normal_draws():
    bn = BatchNorm((T, D), tied_affine=True)
    assert tuple(bn.scale.shape) == tuple(bn.bias.shape) == (D,)
    assert tuple(bn.mean.shape) == tuple(bn.var.shape) == (T, D)
    assert tuple(BatchNorm((T, D)).scale.shape) == (T, D)
    g = torch.Generator().manual_seed(0)
    w = xavier_normal_init((4, 200, 300), g)
    np.testing.assert_allclose(float(w.std()), np.sqrt(2 / 500), rtol=0.02)
    assert torch.equal(w, xavier_normal_init(
        (4, 200, 300), torch.Generator().manual_seed(0)))


def test_fm_ops_draw_flax_initializers_and_refuse_unknown_kernels():
    """OuterProductNetwork's kernels follow flax's xavier_uniform (fans of
    the last two axes times the receptive field), CIN's conv kernels
    U(+-1/sqrt(F * H)) with zero biases; an unknown kernel type raises as
    in the JAX package."""
    g = torch.Generator().manual_seed(0)
    for kind, fields, shape in (("mat", 9, (36, 36, 36)),
                                ("vec", 20, (190, 32)),
                                ("num", 20, (190, 1))):
        k = fm.OuterProductNetwork(fields, shape[-1] if kind == "mat" else 32,
                                   kind, generator=g).kernel.detach()
        assert tuple(k.shape) == shape
        rf = int(np.prod(shape[:-2]))
        bound = np.sqrt(6 / (shape[-2] * rf + shape[-1] * rf))
        assert float(k.abs().max()) <= bound
        np.testing.assert_allclose(float(k.std()), bound / np.sqrt(3),
                                   rtol=0.05)
    cin = fm.CompressedInteractionNetwork(9, (16, 8), generator=g)
    assert tuple(cin.conv_1.shape) == (9 * 8, 8)  # after the split
    assert float(cin.conv_0.detach().abs().max()) <= 1 / np.sqrt(81)
    assert torch.all(cin.conv_b_0.detach() == 0)
    # 'mat' is defined where the pair count equals the embedding width
    # (F = 5: 10 pairs, D = 10, the cases above); elsewhere the JAX op
    # fails in its einsum and the port refuses by name
    with pytest.raises(ValueError, match="pair count"):
        fm.OuterProductNetwork(9, 32, "mat")
    with pytest.raises(ValueError, match="Size of label 'e'"):
        jfm.OuterProductNetwork(9, 32, "mat").init(
            jax.random.PRNGKey(0), jnp.zeros((2, 9, 32)))
    with pytest.raises(ValueError, match="kernel type"):
        fm.OuterProductNetwork(F, D, "tensor")
    with pytest.raises(ValueError, match="kernel type"):
        jfm.OuterProductNetwork(F, D, "tensor").init(
            jax.random.PRNGKey(0), jnp.zeros((2, F, D)))


@pytest.mark.parametrize("method", [None, "mean", "sum"])
def test_features_embedding_matches_flax(method):
    """The fused lookup with the history fields pooled or, with
    ``method=None``, left one output field per slot: [B, n_one_hot +
    n_seq * maxlen, D]; bitwise unpooled (a gather), atol 1e-5 pooled (a
    mean may divide or multiply by the reciprocal)."""
    dims, n_seq, maxlen = (7, 5, 3, 9), 2, 3
    rng = np.random.default_rng(1)
    x = np.concatenate([np.stack([rng.integers(0, d, 16) for d in dims], 1),
                        rng.integers(0, dims[0], (16, n_seq * maxlen))], 1)
    jm = jemb.FeaturesEmbedding(dims, 4, (False,) * 4 + (True,) * 6, 0,
                                maxlen, method)
    variables = seeded_variables(jm, jnp.asarray(x, jnp.int32))
    want = jm.apply(variables, jnp.asarray(x, jnp.int32))
    tm = FeaturesEmbedding(dims, 4, n_seq, 0, maxlen, method)
    tm.load_state_dict(convert_variables(
        jax.tree_util.tree_map(np.asarray, variables["params"]), {}, 4))
    got, _ = tm(torch.tensor(x))
    n_fields = 4 + (n_seq * maxlen if method is None else n_seq)
    assert tuple(got.shape) == (16, n_fields, 4) == want.shape
    _close(got.numpy(), want, f"method={method}")
    if method is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="multi-hot"):
        FeaturesEmbedding(dims, 4, n_seq, 0, maxlen, "max")


@pytest.mark.parametrize("use_bias", [True, False])
def test_features_linear_matches_flax(use_bias):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, D)).astype(np.float32)
    jm = jemb.FeaturesLinear(D, 1, use_bias=use_bias)
    variables = seeded_variables(jm, jnp.asarray(x))
    tm = FeaturesLinear(D, 1, use_bias=use_bias)
    assert (tm.bias is None) == (not use_bias)
    tm.load_state_dict(convert_variables(
        jax.tree_util.tree_map(np.asarray, variables["params"]), {}, D))
    with torch.no_grad():
        got = tm(torch.tensor(x))
    _close(got.numpy(), jm.apply(variables, jnp.asarray(x)), "linear")
