"""The port's 2AFC lin-head trainer (``ganleaks_tpu_torch.ops.lpips.
train2afc``) against the JAX package on the CPU (mirrors
``tests/test_train2afc.py``, all but its case that runs the reference
checkout).

The JAX step draws its dropout from ``jax.random``, so one step is held
against a JAX composition of the package's public ``_features``,
``normalize_tensor``, ``dist2logit`` and ``bce_ranking_loss`` given the
same numpy keep masks as the port's step: loss within rtol 1e-5, and the
gradients of the lin heads, the rank net and the tower each within 1e-5
of their largest entry (float32; the towers sum in different orders).
Three Adam steps are held against ``optax.adam`` on those gradients,
parameters within 1e-6. The rank net, the loss, the accuracy and the LR schedule are held
against the JAX functions and the reference's torch modules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as tnn

from ganleaks_tpu.ops import lpips as jl
from ganleaks_tpu.ops.lpips import train2afc as jt
from ganleaks_tpu.ops.lpips.lpips import _features as j_features
from ganleaks_tpu.ops.lpips.scoring import score_2afc
from ganleaks_tpu_torch.device import set_f32_numerics
from ganleaks_tpu_torch.ops.lpips import lpips as tl
from ganleaks_tpu_torch.ops.lpips import train2afc as tt
from ganleaks_tpu_torch.weights import lpips_from_jax_params
from tests.test_train2afc import TorchDist2Logit, _make_triplets


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's CPU thread
    pool in each of them, on top of the others, slows every process many
    times over. One thread per process for this module's convolutions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    set_f32_numerics()
    yield
    torch.set_num_threads(before)


def _jax_rank(rank: tt.Dist2Logit) -> dict:
    """The JAX ``dist2logit`` params of the port's rank net (copies: a JAX
    array on the CPU may share a numpy array's memory, and the port's
    step updates its weights in place)."""
    out = {}
    for i, lin in enumerate(rank.linears):
        out[f"w{i}"] = jnp.asarray(lin.weight.detach().numpy().T.copy())
        out[f"b{i}"] = jnp.asarray(lin.bias.detach().numpy().copy())
    return out


def _rank_from_reference(ref: TorchDist2Logit) -> tt.Dist2Logit:
    rank = tt.Dist2Logit()
    convs = [m for m in ref.model if isinstance(m, tnn.Conv2d)]
    with torch.no_grad():
        for lin, conv in zip(rank.linears, convs):
            lin.weight.copy_(conv.weight[:, :, 0, 0])
            lin.bias.copy_(conv.bias)
    return rank


def _np_params(p):
    return {"net": p["net"],
            "convs": [{k: np.asarray(v) for k, v in c.items()}
                      for c in p["convs"]],
            "lins": [np.asarray(w) for w in p["lins"]]}


# ---------------------------------------------------------------------------
# Dist2Logit, the loss, accuracy and schedule
# ---------------------------------------------------------------------------

def test_dist2logit_matches_reference_and_jax(rng):
    torch.manual_seed(0)
    ref = TorchDist2Logit()
    rank = _rank_from_reference(ref)
    d0 = rng.uniform(0.0, 2.0, 17).astype(np.float32)
    d1 = rng.uniform(0.0, 2.0, 17).astype(np.float32)
    want = ref(torch.from_numpy(d0).view(-1, 1, 1, 1),
               torch.from_numpy(d1).view(-1, 1, 1, 1))
    with torch.no_grad():
        got = rank(torch.from_numpy(d0), torch.from_numpy(d1)).numpy()
    np.testing.assert_allclose(got, want.detach().numpy().reshape(-1),
                               rtol=1e-5, atol=1e-6)
    j = jt.dist2logit(_jax_rank(rank), jnp.asarray(d0), jnp.asarray(d1))
    np.testing.assert_allclose(got, np.asarray(j), rtol=1e-5, atol=1e-6)


def test_dist2logit_init_is_seeded_at_the_default_scale():
    """torch's default Linear/Conv2d init distribution (U(+-1/sqrt(fan_in))
    for weights and biases), drawn from a generator: same seed, same
    weights."""
    a, b, c = tt.Dist2Logit(seed=0), tt.Dist2Logit(seed=0), \
        tt.Dist2Logit(seed=1)
    for la, lb, lc in zip(a.linears, b.linears, c.linears):
        torch.testing.assert_close(la.weight, lb.weight, rtol=0, atol=0)
        assert not torch.equal(la.weight, lc.weight)
        bound = 1.0 / la.in_features ** 0.5
        assert float(la.weight.abs().max()) <= bound
        assert float(la.bias.abs().max()) <= bound
    assert [(lin.in_features, lin.out_features) for lin in a.linears] \
        == [(5, 32), (32, 32), (32, 1)]


def test_bce_ranking_loss_matches_reference_and_jax(rng):
    torch.manual_seed(1)
    ref = TorchDist2Logit()
    rank = _rank_from_reference(ref)
    d0 = rng.uniform(0.0, 2.0, 13).astype(np.float32)
    d1 = rng.uniform(0.0, 2.0, 13).astype(np.float32)
    judge = rng.uniform(0.0, 1.0, 13).astype(np.float32)
    logit = ref(torch.from_numpy(d0).view(-1, 1, 1, 1),
                torch.from_numpy(d1).view(-1, 1, 1, 1))
    want = tnn.BCELoss()(logit, torch.from_numpy(judge).view(-1, 1, 1, 1))
    with torch.no_grad():
        got = tt.bce_ranking_loss(rank, torch.from_numpy(d0),
                                  torch.from_numpy(d1),
                                  torch.from_numpy(judge))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    j = jt.bce_ranking_loss(_jax_rank(rank), jnp.asarray(d0),
                            jnp.asarray(d1), jnp.asarray(judge))
    np.testing.assert_allclose(float(got), float(j), rtol=1e-5, atol=1e-6)


def test_bce_ranking_loss_saturated_logit_is_clamped():
    """p == 1 with target 0 follows BCELoss's log clamp at -100."""
    rank = tt.Dist2Logit()
    with torch.no_grad():
        rank.linears[2].weight.zero_()
        rank.linears[2].bias.fill_(60.0)
        loss = tt.bce_ranking_loss(rank, torch.ones(4), torch.ones(4),
                                   torch.zeros(4))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), 100.0)


def test_accuracy_and_lr_schedule_match_jax(rng):
    d0, d1, gt = rng.uniform(size=50), rng.uniform(size=50), \
        rng.uniform(size=50)
    d1[:5] = d0[:5]  # ties count toward p0
    assert tt.compute_accuracy(d0, d1, gt) == jt.compute_accuracy(d0, d1,
                                                                  gt)
    assert tt.compute_accuracy(d0 + 1, d1, gt) == pytest.approx(
        score_2afc(d0 + 1, d1, gt))
    lr, epochs, dec = 1e-3, 3, 4
    got = [tt.linear_lr_schedule(lr, epochs, dec, e) for e in range(9)]
    want = [jt.linear_lr_schedule(lr, epochs, dec, e) for e in range(9)]
    assert got == want
    np.testing.assert_allclose(got[:7], [lr, lr, lr, lr, lr * 3 / 4,
                                         lr * 2 / 4, lr / 4], rtol=1e-12)
    assert min(got[:7]) > 0.0 and got[8] == 0.0


# ---------------------------------------------------------------------------
# one step, and Adam, against a JAX composition on the same masks
# ---------------------------------------------------------------------------

def _j_pair_train(p, x, y, keep):
    fx = j_features(p, x)
    fy = j_features(p, y)
    val = 0.0
    for fl_x, fl_y, w, k in zip(fx, fy, p["lins"], keep):
        diff = jnp.square(jl.normalize_tensor(fl_x)
                          - jl.normalize_tensor(fl_y))
        diff = jnp.where(k, diff * 2.0, 0.0)
        val = val + jnp.mean(jnp.sum(diff * w, axis=-1), axis=(1, 2))
    return val


def _j_loss(trainable, frozen, batch, keep0, keep1):
    p = dict(frozen, lins=trainable["lins"])
    if "convs" in trainable:
        p["convs"] = trainable["convs"]
    d0 = _j_pair_train(p, batch["ref"], batch["p0"], keep0)
    d1 = _j_pair_train(p, batch["ref"], batch["p1"], keep1)
    return jt.bce_ranking_loss(trainable["rank"], d0, d1, batch["judge"])


def _setup(net, res, seed=0, n=4):
    rng = np.random.default_rng(seed)
    p = jl.init_lpips_params(seed=seed, net=net)
    p["lins"] = [jnp.asarray(rng.uniform(0.0, 2.0 / w.size, w.shape)
                             .astype(np.float32)) for w in p["lins"]]
    model = lpips_from_jax_params(_np_params(p)).eval()
    rank = tt.Dist2Logit(seed=seed)
    batch = {k: rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
             for k in ("ref", "p0", "p1")}
    batch["judge"] = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return p, model, rank, batch


def _masks(model, shape, seed):
    g = torch.Generator().manual_seed(seed)
    keep0 = tt.dropout_masks(model, shape, g, "cpu")
    keep1 = tt.dropout_masks(model, shape, g, "cpu")
    return keep0, keep1, ([jnp.asarray(k.numpy()) for k in keep0],
                          [jnp.asarray(k.numpy()) for k in keep1])


def _trainable_jax(p, rank, tune):
    out = {"lins": list(p["lins"]), "rank": _jax_rank(rank)}
    if tune:
        out["convs"] = list(p["convs"])
    return out


@pytest.mark.parametrize("net,res,tune", [
    ("vgg", 16, False), ("squeeze", 32, True)])
def test_step_loss_and_gradients_match_jax(net, res, tune):
    p, model, rank, batch = _setup(net, res)
    keep0, keep1, jkeep = _masks(model, batch["ref"].shape, 5)
    step, _ = tt.make_2afc_step(model, rank, tune_backbone=tune)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # lr 0: the step leaves the gradients in .grad and moves nothing
    loss, d0, d1 = step(tb, 0.0, keep0, keep1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    trainable = _trainable_jax(p, rank, tune)
    jloss, jgrad = jax.value_and_grad(_j_loss)(trainable, p, jb, *jkeep)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert d0.shape == d1.shape == (4,)
    groups = {"lins": [(b.grad, g) for b, g in zip(model.lins,
                                                   jgrad["lins"])],
              "rank": [(lin.weight.grad.T, jgrad["rank"][f"w{i}"])
                       for i, lin in enumerate(rank.linears)]
              + [(lin.bias.grad, jgrad["rank"][f"b{i}"])
                 for i, lin in enumerate(rank.linears)]}
    if tune:
        groups["convs"] = [
            (c.weight.grad.permute(2, 3, 1, 0), g["kernel"])
            for c, g in zip(model.tower.convs, jgrad["convs"])] + [
            (c.bias.grad, g["bias"])
            for c, g in zip(model.tower.convs, jgrad["convs"])]
    else:
        assert all(c.weight.grad is None for c in model.tower.convs)
    for name, pairs in groups.items():
        # each group (lin heads, rank net, tower) within 1e-5 of its
        # largest entry: a deep tap's lin gradient is built from squared
        # differences of nearly parallel unit vectors, which keep only the
        # absolute float32 accuracy of the two towers
        got = np.concatenate([g.numpy().reshape(-1) for g, _ in pairs])
        want = np.concatenate([np.asarray(w).reshape(-1) for _, w in pairs])
        assert got.shape == want.shape
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= 1e-5, (name, err)
    # requires_grad is restored after the step
    assert not any(b.requires_grad for b in model.lins)
    assert all(q.requires_grad for q in model.tower.parameters())


def test_adam_three_steps_match_optax():
    p, model, rank, batch = _setup("vgg", 16, seed=1)
    step, opt = tt.make_2afc_step(model, rank)
    assert opt.defaults["betas"] == (0.5, 0.999)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    trainable = _trainable_jax(p, rank, False)
    jopt = optax.adam(learning_rate=1e-3, b1=0.5, b2=0.999)
    state = jopt.init(trainable)
    for t in range(3):
        keep0, keep1, jkeep = _masks(model, batch["ref"].shape, 10 + t)
        step(tb, 1e-3, keep0, keep1)
        grads = jax.grad(_j_loss)(trainable, p, jb, *jkeep)
        updates, state = jopt.update(grads, state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        trainable["lins"] = [jnp.maximum(w, 0.0) for w in trainable["lins"]]
    for b, w in zip(model.lins, trainable["lins"]):
        assert float(b.min()) >= 0.0
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    for i, lin in enumerate(rank.linears):
        np.testing.assert_allclose(lin.weight.detach().numpy().T,
                                   np.asarray(trainable["rank"][f"w{i}"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(trainable["rank"][f"b{i}"]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# dropout and the trainer
# ---------------------------------------------------------------------------

def test_dropout_train_forward_averages_to_inference(rng):
    """E[dropout forward] == inference forward (p = 0.5, 2x rescale)."""
    model = tl.init_lpips_params(seed=0, net="vgg").eval()
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        want = tl.lpips_pair(model, x, y).numpy()
        draws = np.stack([tt.lpips_pair_train(
            model, x, y, tt.dropout_masks(model, x.shape, g, "cpu")).numpy()
            for _ in range(200)])
    np.testing.assert_allclose(draws.mean(0), want, rtol=0.15)
    assert draws.std(0).min() > 0


def test_train_2afc_improves_accuracy_and_keeps_lins_nonneg(rng):
    model = tl.init_lpips_params(seed=3, net="vgg").eval()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():  # random heads: headroom to learn
        for b in model.lins:
            b.uniform_(0.0, 2.0 / b.numel(), generator=g)
    batches = _make_triplets(rng, n=32)

    def acc():
        with torch.no_grad():
            d0 = np.concatenate([tl.lpips_pair(
                model, torch.from_numpy(b["ref"]),
                torch.from_numpy(b["p0"])).numpy() for b in batches])
            d1 = np.concatenate([tl.lpips_pair(
                model, torch.from_numpy(b["ref"]),
                torch.from_numpy(b["p1"])).numpy() for b in batches])
        return score_2afc(d0, d1, np.concatenate([b["judge"]
                                                  for b in batches]))

    acc_before = acc()
    trained, rank, hist = tt.train_2afc(model, batches, epochs=3,
                                        decay_epochs=2, lr=5e-3, seed=0)
    assert trained is model and isinstance(rank, tt.Dist2Logit)
    assert [h["lr"] for h in hist] == [5e-3, 5e-3, 5e-3, 5e-3, 2.5e-3]
    assert all(float(b.min()) >= 0.0 for b in model.lins)
    assert hist[-1]["loss"] < hist[0]["loss"]
    acc_after = acc()
    assert acc_after >= acc_before - 0.02  # no regression beyond noise
    assert acc_after > 0.6  # learned the judgment direction


def test_train_2afc_tune_backbone_updates_convs_and_clamps_1x1(rng):
    """Under ``tune_backbone`` the tower trains too, and the clamp projects
    squeeze's 1x1 conv kernels (not their biases) to >= 0."""
    model = tl.init_lpips_params(seed=1, net="squeeze").eval()
    before = [c.weight.detach().clone() for c in model.tower.convs]
    batches = _make_triplets(rng, n=16, res=32)
    tt.train_2afc(model, batches, epochs=1, decay_epochs=0, lr=1e-3,
                  seed=0, tune_backbone=True)
    ones = [c for c in model.tower.convs if c.kernel_size == (1, 1)]
    assert len(ones) == 16  # squeeze and expand1x1 of eight fire modules
    assert all(float(c.weight.min()) >= 0.0 for c in ones)
    assert any(float(c.bias.min()) < 0.0 for c in ones)
    assert not torch.allclose(before[0], model.tower.convs[0].weight)
    assert not any(b.requires_grad for b in model.lins)
