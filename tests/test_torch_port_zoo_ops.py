"""The zoo's ops in the port (aread_tpu_torch/ops/mlp.py ``GateNN`` and
BatchNorm's ``tied_affine`` / ``scale_mod`` / ``bias_mod``;
aread_tpu_torch/ops/cross.py ``CrossNetV2`` and ``CrossNetMix``) against
the flax modules of aread_tpu/ops, from the same weights (carried by
aread_tpu_torch/convert.py) on the same seed-made inputs: the output, the
gradient of a fixed weighted sum of it for every parameter and every
input, and BatchNorm's running statistics, in eval and in train (a masked
batch). Tolerance atol 1e-5: f32 products summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aread_tpu.ops.cross import CrossNetMix as JCrossNetMix
from aread_tpu.ops.cross import CrossNetV2 as JCrossNetV2
from aread_tpu.ops.mlp import BatchNorm as JBatchNorm
from aread_tpu.ops.mlp import GateNN as JGateNN
from aread_tpu_torch.convert import convert_variables, flatten
from aread_tpu_torch.ops.cross import CrossNetMix, CrossNetV2
from aread_tpu_torch.ops.initializers import xavier_normal_init
from aread_tpu_torch.ops.mlp import BatchNorm, GateNN
from tests.test_torch_port_zoo import seeded_variables

B, T, D = 32, 3, 10


def _bn_inputs(rng):
    return {"x": rng.standard_normal((B, T, D)) * 2 + 1,
            "mask": (np.arange(B) < B - 5).astype(np.float32)}


def _bn_mod_inputs(rng):
    return {**_bn_inputs(rng), "scale_mod": rng.uniform(0.5, 1.5, (1, D)),
            "bias_mod": rng.uniform(-0.5, 0.5, (1, D))}


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
    params = variables["params"]
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
