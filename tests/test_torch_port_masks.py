"""The port's HEMP mask machinery (aread_tpu_torch/utils/masks.py) against
aread_tpu.utils.masks. Everything here is integer or boolean work on the
same numpy stream, so every comparison is exact: every generate_mask mode
and the generator's position after it, prun_single_mask, update_all_mask,
cluster_domain_masks, a mixed sequence of calls from one seed; and the
tensor twins validate_mask_tensor / prune_mask_tensor against
validate_mask_jax / prune_mask_jax and against the host versions over
hypothesis-drawn masks and gate means (gate values are drawn from a
continuous distribution, so no value ties with the interpolated
threshold), including the no-positive-gate and dead-output reverts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aread_tpu.utils import masks as J
from aread_tpu_torch.convert import convert_mask_state
from aread_tpu_torch.utils import masks as P

N_TOWERS = [(2, 3, 4), (3, 6, 12), (2, 4)]
MODES = ["rand", "mask_norm_rand", "max_gate", "max_gate_norm_rand",
         "mask_max_gate"]


def _assert_masks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype == np.bool_
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _same_stream(a, b):
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


def _random_gates(rng, n_tower, zero_p=0.0):
    """One record: [T_{l-1}, T_l] f32 matrices for levels 1..n_level-1."""
    out = []
    for a, b in P.mask_shapes(n_tower)[1:-1]:
        g = (rng.random((a, b)) + 1e-3).astype(np.float32)
        g[rng.random((a, b)) < zero_p] = 0.0
        out.append(g)
    return out


def _pair(n_tower, n_domain, seed, with_masks, n_records):
    """The JAX package's state and the port's, fed the same records."""
    js = J.HempMaskState(n_tower, n_domain, seed=seed)
    ps = P.HempMaskState(n_tower, n_domain, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for d in range(n_domain):
        if with_masks:
            m = js.generate_mask("rand", d, 0.6)
            _assert_masks_equal(m, ps.generate_mask("rand", d, 0.6))
            js.domain_mask[d] = m
            ps.domain_mask[d] = [x.copy() for x in m]
        for _ in range(n_records):
            g = _random_gates(rng, n_tower, zero_p=0.2)
            js.record_gates(d, g)
            ps.record_gates(d, [x.copy() for x in g])
    return js, ps


def test_shapes_and_counts():
    for nt in N_TOWERS:
        assert P.mask_shapes(nt) == J.mask_shapes(nt)
        assert P.edge_num(nt) == J.edge_num(nt)
        m = P.create_single_full_mask(nt, 0.5, np.random.default_rng(0))
        assert P.count_active_edge(m) == J.count_active_edge(m)
    # every method of the JAX class exists in the port
    names = {n for n in dir(J.HempMaskState) if not n.startswith("_")}
    assert names <= set(dir(P.HempMaskState))


@pytest.mark.parametrize("n_tower", N_TOWERS, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_generate_mask_modes_match_jax(mode, n_tower):
    js, ps = _pair(n_tower, 3, seed=7, with_masks=True, n_records=3)
    for d in range(3):
        for pct, sigma in ((0.7, 0.2), (0.4, 0.5)):
            a = js.generate_mask(mode, d, pct, sigma)
            b = ps.generate_mask(mode, d, pct, sigma)
            _assert_masks_equal(a, b)
            assert P.has_output(b)
            _same_stream(js, ps)
    assert js.gate_value_threshold == ps.gate_value_threshold


@pytest.mark.parametrize("mode", ["max_gate_norm_rand", "mask_max_gate"])
def test_generate_mask_without_records_or_masks(mode):
    """No gate record gives no threshold: the modes fall back to a 'rand'
    mask, and mask_max_gate starts from it when the domain has no mask."""
    js, ps = _pair((2, 3, 4), 2, seed=3, with_masks=False, n_records=0)
    for d in range(2):
        _assert_masks_equal(js.generate_mask(mode, d, 0.6, 0.3),
                            ps.generate_mask(mode, d, 0.6, 0.3))
        _same_stream(js, ps)
    assert ps.gate_value_threshold == [None, None]
    with pytest.raises(ValueError, match="unknown generate_mode"):
        ps.generate_mask("nope", 0)


@pytest.mark.parametrize("n_tower", N_TOWERS, ids=str)
def test_gate_accumulator_and_threshold(n_tower):
    js, ps = _pair(n_tower, 2, seed=5, with_masks=False, n_records=4)
    for d in range(2):
        assert len(ps.gate_acc[d]) == len(js.gate_acc[d]) == 4
        jm, pm = js.gate_acc[d].mean_values(), ps.gate_acc[d].mean_values()
        for a, b in zip(jm, pm):
            np.testing.assert_array_equal(a, b)
        for pct in (0.7, 0.3):
            assert P.gate_threshold(pm, pct) == J.gate_threshold(jm, pct)
    empty = P.GateAccumulator(tuple(n_tower)).mean_values()
    assert P.gate_threshold(empty, 0.7) is None
    ps.reset_for_mask_update(0)
    assert len(ps.gate_acc[0]) == 0 and len(ps.gate_acc[1]) == 4


@pytest.mark.parametrize("seed", range(6))
def test_prun_single_mask_matches_jax(seed):
    n_tower = (3, 6, 12)
    rng = np.random.default_rng(seed)
    js = J.HempMaskState(n_tower, 1, seed=seed)
    ps = P.HempMaskState(n_tower, 1, seed=seed)
    mask = js.generate_mask("rand", 0, 0.8)
    for _ in range(4):  # progressive: the output of one prune feeds the next
        gates = [np.where(mask[li + 1], g, 0.0).astype(np.float32)
                 for li, g in enumerate(_random_gates(rng, n_tower))]
        js.record_tmp_gates(gates, mask)
        ps.record_tmp_gates(gates, mask)
        a = js.prun_single_mask(0, mask)
        b = ps.prun_single_mask(0, [m.copy() for m in mask])
        _assert_masks_equal(a, b)
        assert ps.tmp_gate_record is None
        mask = a
    with pytest.raises(ValueError, match="no tmp gate record"):
        ps.prun_single_mask(0, mask)
    zeros = [np.zeros(s, np.float32) for s in P.mask_shapes(n_tower)[1:-1]]
    ps.record_tmp_gates(zeros, mask)
    with pytest.raises(ValueError, match="no valid tmp_tower_gate_values"):
        ps.prun_single_mask(0, mask)


def test_update_all_mask_and_active_ratio():
    n_tower = (2, 3, 4)
    js, ps = _pair(n_tower, 3, seed=11, with_masks=True, n_records=2)
    rng = np.random.default_rng(0)
    for d in (0, 2):  # domain 1 has no candidate and keeps its mask
        for z in range(3):
            cand = js.generate_mask("mask_max_gate", d, 0.6, 0.3)
            _assert_masks_equal(cand, ps.generate_mask("mask_max_gate", d,
                                                       0.6, 0.3))
            js.candidate_domain_mask[d].append(cand)
            ps.candidate_domain_mask[d].append([m.copy() for m in cand])
            for loss in rng.random(2):
                js.add_eval_loss(float(loss), d, z)
                ps.add_eval_loss(float(loss), d, z)
    assert js.eval_loss == ps.eval_loss
    keep = [m.copy() for m in ps.domain_mask[1]]
    js.update_all_mask()
    ps.update_all_mask()
    for d in range(3):
        _assert_masks_equal(js.domain_mask[d], ps.domain_mask[d])
    _assert_masks_equal(keep, ps.domain_mask[1])
    assert ps.current_active_ratio() == js.current_active_ratio()
    ps.init_full_masks()
    assert ps.current_active_ratio() == 1.0


@pytest.mark.parametrize("n_tower,n_domain", [((2, 4), 8), ((3, 6), 12),
                                              ((2, 4, 8), 8)])
def test_cluster_domain_masks_match_jax(n_tower, n_domain):
    # a chain linkage: cluster i + n_domain - 1 absorbs domain i + 1
    z = np.zeros((n_domain - 1, 4))
    z[0, :2] = (0, 1)
    for i in range(1, n_domain - 1):
        z[i, :2] = (n_domain + i - 1, i + 1)
    jm, jt = J.cluster_domain_masks(z, n_tower, n_domain)
    pm, pt = P.cluster_domain_masks(z, n_tower, n_domain)
    assert jt == pt
    for a, b in zip(jm, pm):
        _assert_masks_equal(a, b)
    ps = P.HempMaskState(n_tower, n_domain)
    assert ps.init_cluster_masks(z) == pt
    with pytest.raises(ValueError, match="linkage matrix"):
        P.cluster_domain_masks(z[:1], n_tower, n_domain)


@pytest.mark.parametrize("seed", [0, 1, 2000])
def test_mask_stream_from_one_seed(seed):
    """A mixed run of the calls one evolution makes, twice over: the same
    masks all along and the same generator position at the end."""
    n_tower = (2, 3, 4)
    js = J.HempMaskState(n_tower, 3, seed=seed)
    ps = P.HempMaskState(n_tower, 3, seed=seed)
    rng = np.random.default_rng(seed)
    for round_ in range(2):
        for d in range(3):
            for _ in range(2):
                g = _random_gates(rng, n_tower, 0.1)
                js.record_gates(d, g)
                ps.record_gates(d, g)
        for d in range(3):
            for z in range(2):
                a = js.generate_mask("mask_max_gate", d, 0.7 * 0.95 ** round_,
                                     0.2 * 0.99 ** round_)
                b = ps.generate_mask("mask_max_gate", d, 0.7 * 0.95 ** round_,
                                     0.2 * 0.99 ** round_)
                _assert_masks_equal(a, b)
                js.candidate_domain_mask[d].append(a)
                ps.candidate_domain_mask[d].append(b)
                loss = float(rng.random())
                js.add_eval_loss(loss, d, z)
                ps.add_eval_loss(loss, d, z)
        js.update_all_mask()
        ps.update_all_mask()
        js.reset_for_mask_update()
        ps.reset_for_mask_update()
    for d in range(3):
        _assert_masks_equal(js.domain_mask[d], ps.domain_mask[d])
    _same_stream(js, ps)


def test_convert_mask_state_copies_every_field():
    js, _ = _pair((2, 3, 4), 3, seed=4, with_masks=True, n_records=2)
    js.candidate_domain_mask[1].append(js.generate_mask("rand", 1))
    js.add_eval_loss(0.5, 1, 0)
    js.record_tmp_gates(_random_gates(np.random.default_rng(1), (2, 3, 4)),
                        None)
    js.generate_mask("max_gate", 2, 0.5)  # sets a threshold
    ps = convert_mask_state(js)
    assert isinstance(ps, P.HempMaskState)
    assert (ps.n_tower, ps.n_domain, ps.edge_num) == (
        js.n_tower, js.n_domain, js.edge_num)
    for d in range(3):
        _assert_masks_equal(js.domain_mask[d], ps.domain_mask[d])
        assert ps.domain_mask[d][0] is not js.domain_mask[d][0]
        for a, b in zip(js.gate_acc[d].mean_values(),
                        ps.gate_acc[d].mean_values()):
            np.testing.assert_array_equal(a, b)
    assert ps.eval_loss == js.eval_loss
    assert ps.gate_value_threshold == js.gate_value_threshold
    _assert_masks_equal(js.candidate_domain_mask[1][0],
                        ps.candidate_domain_mask[1][0])
    for a, b in zip(js.tmp_gate_record, ps.tmp_gate_record):
        np.testing.assert_array_equal(a, b)
    _same_stream(js, ps)
    # the copies draw the same masks from here on
    _assert_masks_equal(js.generate_mask("mask_max_gate", 0, 0.6, 0.3),
                        ps.generate_mask("mask_max_gate", 0, 0.6, 0.3))


# ------------------------------------------------------------- tensor twins
def _t(mask):
    return tuple(torch.tensor(np.asarray(m)) for m in mask)


def _j(mask):
    return tuple(jnp.asarray(np.asarray(m)) for m in mask)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), keep=st.floats(0.05, 0.95),
       n_tower=st.sampled_from(N_TOWERS))
def test_validate_mask_tensor_matches_jax_and_host(seed, keep, n_tower):
    rng = np.random.default_rng(seed)
    mask = [rng.random(s) < keep for s in P.mask_shapes(n_tower)]
    host = P.validate_mask(mask)
    _assert_masks_equal(host, J.validate_mask(mask))
    got = P.validate_mask_tensor(_t(mask))
    _assert_masks_equal(host, [m.numpy() for m in got])
    _assert_masks_equal(J.validate_mask_jax(_j(mask)),
                        [m.numpy() for m in got])
    # a valid mask is a fixpoint
    _assert_masks_equal(got, P.validate_mask_tensor(got))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), keep=st.floats(0.2, 1.0),
       zero_p=st.floats(0.0, 0.9), n_tower=st.sampled_from(N_TOWERS),
       ratio=st.sampled_from([0.05, 0.3, 0.9]),
       dead_level=st.sampled_from([None, 0, 1]))
def test_prune_mask_tensor_matches_jax_and_host(seed, keep, zero_p, n_tower,
                                                ratio, dead_level):
    """``dead_level``: that level's gate means are all 0 (a level with no
    positive value leaves the threshold to the others; with every level
    dead the mask comes back unchanged)."""
    rng = np.random.default_rng(seed)
    mask = [np.ones(s, bool) for s in P.mask_shapes(n_tower)]
    for m in mask[1:-1]:
        m &= rng.random(m.shape) < keep
    gates = [np.where(mask[li + 1], g, 0.0).astype(np.float32)
             for li, g in enumerate(_random_gates(rng, n_tower, zero_p))]
    if dead_level is not None and dead_level < len(gates):
        gates[dead_level][:] = 0.0
    host = P.prune_mask(mask, gates, ratio)
    got = [m.numpy() for m in P.prune_mask_tensor(
        _t(mask), tuple(torch.tensor(g) for g in gates), ratio)]
    jax_ = J.prune_mask_jax(_j(mask), tuple(jnp.asarray(g) for g in gates),
                            prun_ratio=ratio)
    _assert_masks_equal(jax_, got)
    _assert_masks_equal(host, got)
    if P.prune_threshold(gates, ratio) is not None:
        js = J.HempMaskState(n_tower, 1)
        js.record_tmp_gates(gates, mask)
        _assert_masks_equal(js.prun_single_mask(0, mask, ratio), got)


def test_prune_reverts_without_a_positive_gate():
    n_tower = (2, 3, 4)
    mask = [np.ones(s, bool) for s in P.mask_shapes(n_tower)]
    zeros = [np.zeros(s, np.float32) for s in P.mask_shapes(n_tower)[1:-1]]
    _assert_masks_equal(mask, P.prune_mask(mask, zeros))
    got = P.prune_mask_tensor(_t(mask), tuple(torch.tensor(g) for g in zeros))
    _assert_masks_equal(mask, [m.numpy() for m in got])
    _assert_masks_equal(J.prune_mask_jax(_j(mask), _j(zeros)),
                        [m.numpy() for m in got])


def test_prune_reverts_when_the_output_dies():
    """One path to one leaf whose last edge carries the smallest positive
    gate value: the threshold cuts it, the leaf and with it the output
    die, and both routes hand the mask back unchanged."""
    n_tower = (2, 3)
    mask = [np.array([[True, False]]),
            np.array([[True, False, False], [False, False, False]]),
            np.array([[True], [False], [False]])]
    _assert_masks_equal(mask, P.validate_mask(mask))
    gates = [np.array([[0.2, 0.9, 0.8], [0.7, 0.6, 0.5]], np.float32)]
    cut = [mask[0], mask[1] & (gates[0] >= P.prune_threshold(gates, 0.05)),
           mask[2]]
    assert not P.has_output(P.validate_mask(cut))  # it would be dead
    _assert_masks_equal(mask, P.prune_mask(mask, gates))
    got = P.prune_mask_tensor(_t(mask), (torch.tensor(gates[0]),))
    _assert_masks_equal(mask, [m.numpy() for m in got])
    _assert_masks_equal(J.prune_mask_jax(_j(mask), _j(gates)),
                        [m.numpy() for m in got])
