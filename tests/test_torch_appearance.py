"""The decoupled appearance network of gof_tpu_torch against gof_tpu's.

The same numpy inputs (and gof_tpu's flax weights, carried across by name
with app_from_numpy) go through both packages. Tolerances: the resizes and
pixel shuffle within 1e-6 (the same f32 arithmetic); the network's output
within atol 1e-5 and appearance_l1 within rtol 1e-5; gradients within
1e-4 x max |gof_tpu| (gof_tpu's Pallas-vs-XLA bound,
tests/test_rasterize.py:154-157); Adam within rtol 1e-6; checkpoints bit
for bit.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gof_tpu import cameras as jcam
from gof_tpu import config as jconfig
from gof_tpu import train as jtrain
from gof_tpu.model import appearance as japp
from gof_tpu.model import gaussians as jgm
from gof_tpu_torch import cameras as tcam
from gof_tpu_torch import config as tconfig
from gof_tpu_torch import train as ttrain
from gof_tpu_torch.model import appearance as tapp
from gof_tpu_torch.model import gaussians as tgm

from make_synthetic_scene import make_scene
from test_torch_train import close, model, rel_err

torch.set_num_threads(2)

BOUND = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def flax_weights(seed=0):
    """gof_tpu's initial weights with random biases (init leaves them 0,
    which would hide a bias mapped to the wrong conv) and embeddings."""
    params, emb = japp.init_appearance(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (rng.normal(0, 0.05, x.shape).astype(np.float32)
                                         if path[-1].key == "bias" else 0), params)
    emb = np.asarray(emb) + rng.normal(0, 0.1, emb.shape).astype(np.float32)
    return params, emb


def net_grads_close(got: dict, want_tree):
    """Port gradients {name: tensor} against gof_tpu's flax gradient tree."""
    want = tapp.net_state_from_flax(jax.device_get(want_tree))
    assert set(got) == set(want)
    for k in want:
        assert np.abs(want[k].numpy()).max() > 0, k
        assert rel_err(got[k].numpy(), want[k].numpy()) <= BOUND, (k, rel_err(got[k], want[k]))


def test_weights_carry_across_by_name():
    params, emb = flax_weights()
    net, temb = tapp.app_from_numpy(params, emb)
    back, bemb = tapp.app_to_numpy(net, temb)
    assert jax.tree.structure(back) == jax.tree.structure(jax.device_get(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(bemb, emb)
    # HWIO kernel -> OIHW weight
    np.testing.assert_array_equal(net.up[2].conv.weight.detach().numpy(),
                                  params["params"]["UpsampleBlock_2"]["Conv_0"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    bad = {"params": dict(params["params"], Extra_0=params["params"]["Conv_2"])}
    with pytest.raises(ValueError, match="Extra_0"):
        tapp.net_state_from_flax(bad)


def test_init_appearance_draws_from_the_generator():
    a, ea = tapp.init_appearance(torch.Generator().manual_seed(0))
    b, eb = tapp.init_appearance(torch.Generator().manual_seed(0))
    c, _ = tapp.init_appearance(torch.Generator().manual_seed(1))
    for (n, x), y, z in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(x, y), n
        assert n.endswith("bias") or not torch.equal(x, z), n
    assert torch.equal(ea, eb) and ea.shape == (2048, 64)
    # flax's init statistics: N(0, 1) * 1e-4 embeddings, lecun-normal kernels
    jp, je = japp.init_appearance(jax.random.PRNGKey(0))
    assert float(ea.std()) == pytest.approx(float(np.std(je)), rel=0.05)
    w = a.conv_in.weight.detach().numpy()
    assert float(w.std()) == pytest.approx(float(np.std(jp["params"]["Conv_0"]["kernel"])),
                                           rel=0.05)
    assert np.abs(w).max() <= 2 * (1 / (67 * 9)) ** 0.5 / 0.87962566103423978 + 1e-7


def test_pixel_shuffle_matches():
    x = np.random.default_rng(1).normal(size=(2, 12, 3, 5)).astype(np.float32)  # NCHW
    got = tapp.pixel_shuffle(t(x), 2).numpy()
    want = np.asarray(japp.pixel_shuffle(jnp.asarray(x.transpose(0, 2, 3, 1)), 2))
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("hw", [(3, 5), (1, 1), (1, 4), (2, 1)])
def test_bilinear_x2_matches(hw):
    x = np.random.default_rng(2).normal(size=(1, 4) + hw).astype(np.float32)
    got = tapp.bilinear_x2_align_corners(t(x)).numpy()
    want = np.asarray(japp.bilinear_x2_align_corners(jnp.asarray(x.transpose(0, 2, 3, 1))))
    assert got.shape == (1, 4, 2 * hw[0], 2 * hw[1])
    close(got, want.transpose(0, 3, 1, 2), rtol=1e-6)


@pytest.mark.parametrize("src,out", [((64, 96), (2, 3)), ((64, 96), (1, 1)), ((1, 1), (3, 2)),
                                     ((5, 7), (70, 95)), ((5, 7), (1, 9))])
def test_bilinear_resize_matches(src, out):
    x = np.random.default_rng(3).uniform(size=(3,) + src).astype(np.float32)
    got = tapp.bilinear_resize_align_corners(t(x), *out).numpy()
    want = np.asarray(japp.bilinear_resize_align_corners(jnp.asarray(x), *out))
    assert got.shape == (3,) + out
    close(got, want, rtol=1e-6)


def test_network_output_and_gradients_match():
    """At a 64x96 crop: the [1, 67, 2, 3] input gives a [1, 3, 64, 96]
    multiplier; its gradients into every weight and into the input."""
    params, _ = flax_weights()
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(1, 2, 3, 67)).astype(np.float32)  # NHWC
    r = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)

    def f(p, xx):
        return jnp.sum(japp.AppearanceNetwork().apply(p, xx) * r)

    want = np.asarray(japp.AppearanceNetwork().apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))

    net, _ = tapp.app_from_numpy(params, np.zeros((2048, 64), np.float32))
    xt = t(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    out = net(xt)
    assert out.shape == (1, 3, 64, 96)
    np.testing.assert_allclose(out.detach().numpy(), want.transpose(0, 3, 1, 2), atol=1e-5)
    torch.sum(out * t(r.transpose(0, 3, 1, 2))).backward()
    net_grads_close({n: p.grad for n, p in net.named_parameters()}, gp)
    assert rel_err(xt.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2)) <= BOUND


def test_conv3x3_gradients_match_finite_differences():
    """The network's conv (its own backward) against torch's numerical
    gradients in float64."""
    rng = np.random.default_rng(5)
    args = [t(rng.normal(size=s)).requires_grad_(True)
            for s in ((2, 3, 6, 7), (4, 3, 3, 3), (4,))]
    assert torch.autograd.gradcheck(tapp._Conv3x3.apply, args)


def test_conv3x3_parameter_gradients_sum_in_float64():
    """In float32 at 512x512 (262,144 pixels per weight gradient entry),
    the weight and bias gradients within 1e-7 x max of float64's; torch's
    float32 conv reads 2.8e-6 / 1.5e-6 here. The input gradient is float32's
    own, as in F.conv2d."""
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(1, 16, 512, 512)).astype(np.float32)
    w = (rng.normal(size=(16, 16, 3, 3)) * 0.1).astype(np.float32)
    b = np.zeros(16, np.float32)
    up = (rng.normal(size=(1, 16, 512, 512)) + 0.05).astype(np.float32)

    def grads(fn, dtype):
        leaves = [t(a).to(dtype).requires_grad_(True) for a in (x, w, b)]
        fn(*leaves).backward(t(up).to(dtype))
        return [leaf.grad.double().numpy() for leaf in leaves]

    conv = lambda a, c, d: torch.nn.functional.conv2d(a, c, d, padding=1)  # noqa: E731
    want = grads(conv, torch.float64)
    got = grads(tapp._Conv3x3.apply, torch.float32)
    plain = grads(conv, torch.float32)
    assert rel_err(got[1], want[1]) <= 1e-7 and rel_err(got[2], want[2]) <= 1e-7
    assert rel_err(got[0], want[0]) == rel_err(plain[0], want[0]) <= 1e-6


def test_appearance_l1_value_and_gradients_match():
    """A 70x95 render (crop 64x64 at an odd offset): the loss, its gradient
    into the image, the network and the used embedding row only; and the
    transformed image resized back."""
    params, emb = flax_weights()
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(3, 70, 95)).astype(np.float32)
    gt = rng.uniform(size=(3, 70, 95)).astype(np.float32)

    def f(im, p, e):
        return japp.appearance_l1(im, jnp.asarray(gt), p, e, 3)

    want, (gi, gp, ge) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(img), params, jnp.asarray(emb))
    net, temb = tapp.app_from_numpy(params, emb)
    ti = t(img).requires_grad_(True)
    temb.requires_grad_(True)
    got = tapp.appearance_l1(ti, t(gt), net, temb, 3)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    got.backward()
    assert rel_err(ti.grad.numpy(), np.asarray(gi)) <= BOUND
    net_grads_close({n: p.grad for n, p in net.named_parameters()}, gp)
    ge = np.asarray(ge)
    assert rel_err(temb.grad.numpy(), ge) <= BOUND
    assert (temb.grad.numpy()[np.arange(2048) != 3] == 0).all() and np.abs(ge[3]).sum() > 0

    with torch.no_grad():
        tr = tapp.appearance_l1(t(img), t(gt), net, temb, 3, return_transformed=True)
    jtr = japp.appearance_l1(jnp.asarray(img), jnp.asarray(gt), params, jnp.asarray(emb), 3,
                             return_transformed=True)
    assert tr.shape == (3, 70, 95)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), atol=1e-5)


def gate_case(seed=7):
    """A seeded appearance step as chip_smoke.py's chain gate holds it: the
    weights at lecun-normal scale with N(0, 0.05) biases (the DTU chain's
    network at step 1000 keeps each conv's weight std within 1.2x of its
    init and its biases under 0.17), a 70x95 render drawn uniformly, and a
    gt that is the render times the network's multiplier plus N(0, 0.02)
    noise in the crop, so that appearance_l1's gradient into the
    multiplier, sign(diff) * crop / n, is mean-zero, as at a trained state.
    Returns (flax params, embeddings, render, gt, the port's network and
    embeddings)."""
    params, emb = flax_weights(seed)
    net, temb = tapp.app_from_numpy(params, emb)
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(3, 70, 95)).astype(np.float32)
    crop = tapp.center_crop_32(t(img))
    with torch.no_grad():
        fit = (tapp.appearance_multiplier(crop, net, temb, 3) * crop).numpy()
    gt = img.copy()
    top, left = 70 // 2 - 64 // 2, 95 // 2 - 64 // 2
    gt[:, top:top + 64, left:left + 64] = fit + rng.normal(0, 0.02, fit.shape)
    return params, emb, img, gt, net, temb


def test_gate_pass_matches_the_network_and_gof_tpu():
    """chip_smoke.app_pass, the gate's step-by-step pass (ROADMAP C31), is
    the network's own forward and backward bit for bit; with the float64
    reference's gradient into the multiplier (app_reference) its gradients
    lie within BOUND of gof_tpu's appearance_l1 gradients and of float64."""
    import chip_smoke

    params, emb, img, gt, net, temb = gate_case()
    crop, up, (_, g64, _) = chip_smoke.app_reference(net, temb, t(img), t(gt), 3)
    assert abs(float(up.sum())) < 0.05 * float(up.abs().sum())
    crop, up = crop.float(), up.float()
    mult, got, acts = chip_smoke.app_pass(net, temb, crop, 3, up)
    assert [n for n, _, _ in acts] == ["conv_in", "relu conv_in"] + [
        s for i in range(4) for s in (f"up.{i} shuffle", f"up.{i}.conv", f"relu up.{i}")] + [
        "bilinear_x2", "conv_mid", "relu conv_mid", "conv_out", "sigmoid"]
    e = temb.clone().requires_grad_(True)
    for p in net.parameters():
        p.grad = None
    want = tapp.appearance_multiplier(crop, net, e, 3)
    want.backward(up)
    assert torch.equal(mult, want.detach())
    for n, p in net.named_parameters():
        assert torch.equal(got[f"net.{n}"], p.grad), n
    assert torch.equal(got["emb"], e.grad)

    def f(p, em):
        return japp.appearance_l1(jnp.asarray(img), jnp.asarray(gt), p, em, 3)

    gp, ge = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(emb))
    net_grads_close({k[4:]: v for k, v in got.items() if k != "emb"}, gp)
    assert rel_err(got["emb"].numpy(), np.asarray(ge)) <= BOUND
    for k in g64:
        assert rel_err(got[k].numpy(), g64[k].numpy()) <= BOUND, k


def test_gate_holds_a_flipped_relu_at_the_reference_masks():
    """ROADMAP C31: a ReLU whose pre-activation lies within an ulp of zero
    can take the other side in float32 than in float64, and with the
    trained state's cancellation that one entry moves a weight gradient by
    far more than the gate's 1e-4. Here up.2's bias puts one entry there
    (stepped by quarter ulps until the CPU's float32 forward flips it):
    chip_smoke.app_hold reports that flip (1 entry, within 64 ulps of the
    layer's largest pre-activation), the float32 gradients at their own
    masks lie over 1e-3 of max off float64, and at the reference's masks
    within 1e-5 on every leaf."""
    import chip_smoke

    *_, img, gt, net, temb = gate_case()
    layer, conv = "relu up.2", net.up[2].conv
    acts64 = chip_smoke.app_reference(net, temb, t(img), t(gt), 3)[2][2]
    pre = dict((n, x) for n, x, _ in acts64)[layer][0]
    at = int(pre.abs().argmin())
    c = at // (pre.shape[1] * pre.shape[2])
    ulp = 2.0 ** (np.floor(np.log2(float(pre.abs().max()))) - 23)
    b0 = float(conv.bias[c])
    for s in np.arange(-4, 4.25, 0.25):
        with torch.no_grad():
            conv.bias[c] = b0 - float(pre.flatten()[at]) + s * ulp
        r = chip_smoke.app_hold(net, temb, t(img), t(gt), 3, f"bias step {s}", "cpu", "cpu")
        if r["flips"][layer][0]:
            break
    assert r["flips"][layer][0] == 1 and r["flips"][layer][1] <= 64, r["flips"]
    assert sum(n for n, _ in r["flips"].values()) == 1
    assert max(r["grad"].values()) > 1e-3
    assert max(r["masks"].values()) <= 1e-5, r["masks"]
    assert r["merr"] <= 1e-5 and r["lerr"] <= 1e-5 and r["emb_rows"] == [3]


def test_adam_updates_appearance_leaves_like_gof_tpu():
    """Three updates from a carried-across state (count 41, random moments):
    gof_tpu's make_optimizer().update against the port's update +
    update_app, at appearance_network_lr and appearance_embeddings_lr."""
    rng = np.random.default_rng(6)
    params, state = model(rng, 32, 32)
    net_p, emb = flax_weights()
    opt = jconfig.OptimizationParams(appearance_network_lr=2e-3, appearance_embeddings_lr=5e-4)
    jtx = jtrain.make_optimizer(opt, 4.0)
    jtp = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=net_p,
                             app_emb=jnp.asarray(emb))
    js = jtx.init(jtp)

    def rand(tree, lo, hi):
        return jax.tree.map(lambda x: jnp.asarray(rng.uniform(lo, hi, np.shape(x)), jnp.float32),
                            tree)

    js = js._replace(count=jnp.int32(41), mu_app=rand(js.mu_app, -1e-3, 1e-3),
                     nu_app=rand(js.nu_app, 0, 1e-6))
    g, _ = tgm.from_numpy(params, state)
    ttx = ttrain.make_optimizer(tconfig.OptimizationParams(appearance_network_lr=2e-3,
                                                           appearance_embeddings_lr=5e-4), 4.0)
    ts = ttrain.from_numpy(jax.device_get(js), g)
    net, temb = tapp.app_from_numpy(net_p, emb)
    tp = ttrain.TrainParams(gauss=g, app_net=net, app_emb=temb)
    assert set(ts.mu_app) == set(ttrain.app_leaves(tp))
    leaves = {k: v.detach().clone() for k, v in ttrain.app_leaves(tp).items()}
    jp = jtp
    for _ in range(3):
        ggrad = jax.tree.map(lambda x: rng.normal(0, 1e-2, np.shape(x)).astype(np.float32),
                             jtp.gauss)
        agrad = jax.tree.map(lambda x: rng.normal(0, 1e-2, np.shape(x)).astype(np.float32),
                             (net_p, emb))
        jgr = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, ggrad),
                                 app_net=jax.tree.map(jnp.asarray, agrad[0]),
                                 app_emb=jnp.asarray(agrad[1]))
        upd, js = jtx.update(jgr, js)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        _, ts = ttx.update(tgm.GaussianParams(*[t(x) for x in ggrad]), ts)
        tgrads = {f"net.{k}": v for k, v in tapp.net_state_from_flax(agrad[0]).items()}
        tgrads["emb"] = t(agrad[1])
        aupd, ts = ttx.update_app(tgrads, ts)
        leaves = {k: v + aupd[k] for k, v in leaves.items()}
    assert ts.count == int(js.count) == 44
    want = {f"net.{k}": v for k, v in tapp.net_state_from_flax(jax.device_get(jp.app_net)).items()}
    want["emb"] = t(jax.device_get(jp.app_emb))
    for tree_t, tree_j in ((ts.mu_app, js.mu_app), (ts.nu_app, js.nu_app)):
        ref = {f"net.{k}": v for k, v in tapp.net_state_from_flax(
            jax.device_get(tree_j[0])).items()}
        ref["emb"] = t(jax.device_get(tree_j[1]))
        for k in ref:
            close(tree_t[k].numpy(), ref[k].numpy(), rtol=1e-6)
    for k in want:
        close(leaves[k].numpy(), want[k].numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# One train step against gof_tpu's build_train_step (test_torch_train's
# harness, with the appearance network on)
# ---------------------------------------------------------------------------

W, H, UID = 96, 64, 5


@pytest.fixture(scope="module")
def app_step_case():
    rng = np.random.default_rng(7)
    params, state = model(rng, 48, 40)
    # gof_tpu's gradient-test scales (ROADMAP C9: smaller gaussians' scales
    # and rotation gradients cancel in f32, and the appearance network's
    # convolutions round the image gradient differently in each package)
    params = params._replace(scaling=np.where(
        np.arange(48)[:, None] < 40, np.log(rng.uniform(0.3, 1.0, (48, 3))),
        params.scaling).astype(np.float32))
    state = state._replace(filter_3d=rng.uniform(1e-4, 5e-3, 48).astype(np.float32))
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    cam = dict(eye=(0.1, -0.05, 0.0), target=(0, 0, 5.0), width=W, height=H, uid=UID)
    net_p, emb = flax_weights(1)
    opt = jconfig.OptimizationParams()
    tx = jtrain.make_optimizer(opt, 5.0)
    tp0 = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params), app_net=net_p,
                             app_emb=jnp.asarray(emb))
    s0 = tx.init(tp0)
    step = jtrain.build_train_step(
        opt, jconfig.ModelParams(sh_degree=1, kernel_size=0.1, use_decoupled_appearance=True),
        jconfig.PipelineParams(key_capacity=8192), tx, interpret=True, with_stats=True,
        with_reg=False)
    tp, s, g, m = step(tp0, s0, jax.tree.map(jnp.asarray, state), jnp.asarray(gt),
                       jnp.int32(100), jcam.look_at_camera(**cam), jnp.zeros(3))
    return params, state, gt, cam, net_p, emb, jax.device_get((tp, s, g, m)), jax.device_get(s0)


def test_train_step_with_appearance_matches_gof_tpu(app_step_case):
    params, state, gt, cam, net_p, emb, (jtp, js, jgs, jm), s0 = app_step_case
    g, s = tgm.from_numpy(params, state)
    opt = tconfig.OptimizationParams()
    tx = ttrain.make_optimizer(opt, 5.0)
    net, temb = tapp.app_from_numpy(net_p, emb)
    tp = ttrain.TrainParams(gauss=g, app_net=net, app_emb=temb)
    st0 = ttrain.from_numpy(s0, g)
    assert st0.mu_app is not None
    step = ttrain.build_train_step(
        opt, tconfig.ModelParams(sh_degree=1, kernel_size=0.1, use_decoupled_appearance=True),
        tconfig.PipelineParams(), tx, with_stats=True, with_reg=False)
    tp, st, gs, m = step(tp, st0, s, t(gt), 100, tcam.look_at_camera(**cam), torch.zeros(3))
    for k in ("loss", "l1", "ssim", "psnr"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7), k
    # appearance_l1 differs from the plain L1 on this input
    assert abs(float(jm["l1"]) - float(np.mean(np.abs(gt)))) > 1e-3
    # after one step from zero moments, mu = (1 - b1) * grad; on the active
    # rows (at these scales gof_tpu's scaling gradient of an inactive slot
    # can be NaN, where the port's is 0)
    jmu = jtrain.unflatten_gauss_t(jnp.asarray(js.mu_flat), params)
    for f in ttrain.GAUSS_FIELDS:
        want = np.asarray(getattr(jmu, f))[:40]
        got = getattr(st.mu, f).numpy()
        if f != "features_rest":
            assert np.abs(want).max() > 0, f
        assert rel_err(got[:40], want) <= BOUND, f
        assert (got[40:] == 0).all(), f
    mu_net, mu_emb = js.mu_app
    net_grads_close({k[4:]: v for k, v in st.mu_app.items() if k != "emb"}, mu_net)
    assert rel_err(st.mu_app["emb"].numpy(), mu_emb) <= BOUND
    rows = np.abs(st.mu_app["emb"].numpy()).sum(1) > 0
    assert rows.tolist() == (np.arange(2048) == UID).tolist()
    # the updated network and embeddings (each parameter moved by about lr)
    got_net, got_emb = tapp.app_to_numpy(tp.app_net, tp.app_emb)
    for a, b in zip(jax.tree.leaves(got_net), jax.tree.leaves(jtp.app_net)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(got_emb, jtp.app_emb, atol=1e-5)
    assert (got_emb[np.arange(2048) != UID] == emb[np.arange(2048) != UID]).all()
    for f in ("grad_accum", "grad_abs_accum"):
        assert rel_err(getattr(gs, f).numpy(), np.asarray(getattr(jgs, f))) <= BOUND, f


def test_train_step_without_the_flag_steps_carried_appearance_like_gof_tpu(app_step_case):
    """Without --use_decoupled_appearance an appearance state that the params
    carry (a gof_tpu checkpoint always holds one) feeds nothing, and both
    packages step it with zero gradients: the state after app_step_case's
    step (non-zero moments, count 1) moves by its momentum alone."""
    params, state, gt, cam, _, _, (jtp, js, _, _), s0 = app_step_case
    opt = jconfig.OptimizationParams()
    tx = jtrain.make_optimizer(opt, 5.0)
    # the gaussians' moments start from zero; the appearance carries step 1's
    js = js._replace(mu_flat=s0.mu_flat, nu_flat=s0.nu_flat)
    step = jtrain.build_train_step(
        opt, jconfig.ModelParams(sh_degree=1, kernel_size=0.1),
        jconfig.PipelineParams(key_capacity=8192), tx, interpret=True, with_stats=True,
        with_reg=False)
    jtp2 = jtrain.TrainParams(gauss=jax.tree.map(jnp.asarray, params),
                              app_net=jax.tree.map(jnp.asarray, jtp.app_net),
                              app_emb=jnp.asarray(jtp.app_emb))
    wtp, wst, _, wm = jax.device_get(step(
        jtp2, jax.tree.map(jnp.asarray, js), jax.tree.map(jnp.asarray, state),
        jnp.asarray(gt), jnp.int32(101), jcam.look_at_camera(**cam), jnp.zeros(3)))

    g, s = tgm.from_numpy(params, state)
    net, emb = tapp.app_from_numpy(jtp.app_net, jtp.app_emb)
    tp = ttrain.TrainParams(gauss=g, app_net=net, app_emb=emb)
    st0 = ttrain.from_numpy(js, g)
    before = {k: v.detach().clone() for k, v in ttrain.app_leaves(tp).items()}
    topt = tconfig.OptimizationParams()
    step = ttrain.build_train_step(topt, tconfig.ModelParams(sh_degree=1, kernel_size=0.1),
                                   tconfig.PipelineParams(), ttrain.make_optimizer(topt, 5.0),
                                   with_stats=True, with_reg=False)
    tp, st, _, m = step(tp, st0, s, t(gt), 101, tcam.look_at_camera(**cam), torch.zeros(3))
    # the plain L1, as gof_tpu's
    assert float(m["l1"]) == pytest.approx(float(wm["l1"]), rel=1e-5, abs=1e-7)
    assert st.count == 2
    want_net, want_emb = tapp.net_state_from_flax(wtp.app_net), t(wtp.app_emb)
    want_mu, want_nu = ttrain.app_moments_from_numpy(wst.mu_app), ttrain.app_moments_from_numpy(
        wst.nu_app)
    for k, x in ttrain.app_leaves(tp).items():
        want = want_emb if k == "emb" else want_net[k[4:]]
        np.testing.assert_allclose(x.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
        for got, w in ((st.mu_app[k], want_mu[k]), (st.nu_app[k], want_nu[k])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6, atol=1e-30,
                                       err_msg=k)
        moved = x.detach() != before[k]
        # the leaves with momentum moved, the others kept their bits
        assert torch.equal(moved, st0.mu_app[k] != 0), k
        assert bool(moved.any()), k


def test_resumed_gof_tpu_checkpoint_without_the_flag_matches_gof_tpu(synth_scene, tmp_path):
    """gof_tpu trains 3 steps with the appearance network and checkpoints;
    both packages resume from that checkpoint without the flag for 2 more
    steps. Their appearance state and its moments agree within rtol 1e-6
    and moved from the checkpoint's."""
    from gof_tpu import config as jconfig_

    ck = str(tmp_path / "gof_app")
    common = dict(densify_from_iter=100, densify_until_iter=10)
    jtrain.training(
        jconfig_.ModelParams(source_path=synth_scene, model_path=ck, sh_degree=1,
                             kernel_size=0.1, use_decoupled_appearance=True),
        jconfig_.OptimizationParams(iterations=3, **common),
        jconfig_.PipelineParams(backend="xla", key_capacity=512), test_iterations=set(),
        save_iterations=set(), checkpoint_iterations={3}, quiet=True)
    path = os.path.join(ck, "chkpnt3.pkl")
    out = str(tmp_path / "gof_resumed")
    jtrain.training(
        jconfig_.ModelParams(source_path=synth_scene, model_path=out, sh_degree=1,
                             kernel_size=0.1),
        jconfig_.OptimizationParams(iterations=5, **common),
        jconfig_.PipelineParams(backend="xla", key_capacity=512), test_iterations=set(),
        save_iterations=set(), checkpoint_iterations={5}, start_checkpoint=path, quiet=True)
    want_tp, want_st, _, _ = ttrain.load_checkpoint(os.path.join(out, "chkpnt5.pkl"))
    port = str(tmp_path / "port_resumed")
    ttrain.main(["-s", synth_scene, "-m", port, "--cpu", "--sh_degree", "1", "--kernel_size",
                 "0.1", "--iterations", "5", "--densify_from_iter", "100",
                 "--densify_until_iter", "10", "--start_checkpoint", path,
                 "--checkpoint_iterations", "5", "--test_iterations", "99", "--quiet"])
    got_tp, got_st, _, it = ttrain.load_checkpoint(os.path.join(port, "chkpnt5.pkl"))
    start_tp, start_st, _, _ = ttrain.load_checkpoint(path)
    assert it == 5 and got_st.count == want_st.count == 5 and start_st.count == 3
    start, got, want = (ttrain.app_leaves(x) for x in (start_tp, got_tp, want_tp))
    assert set(got) == set(want) == set(start)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].detach().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        for m in ("mu_app", "nu_app"):
            np.testing.assert_allclose(getattr(got_st, m)[k].numpy(),
                                       getattr(want_st, m)[k].numpy(), rtol=1e-6, atol=1e-30,
                                       err_msg=(m, k))
        assert not torch.equal(got[k].detach(), start[k].detach()), k
        assert not torch.equal(got_st.mu_app[k], start_st.mu_app[k]), k


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_scene(root, n_gaussians=16, n_views=8, size=64)
    return root


def test_gof_tpu_checkpoint_with_appearance_loads_and_resumes(synth_scene, tmp_path):
    """A port run's state written by gof_tpu.train.save_checkpoint (app_net,
    app_emb, mu_app, nu_app in gof_tpu's trees) loads into the port bit for
    bit, and train.main --use_decoupled_appearance resumes from it."""
    out = str(tmp_path / "run")
    argv = ["-s", synth_scene, "-m", out, "--cpu", "--sh_degree", "1", "--kernel_size", "0.1",
            "--use_decoupled_appearance", "--quiet"]
    ttrain.main(argv + ["--iterations", "3", "--checkpoint_iterations", "3"])
    tp, st, gs, _ = ttrain.load_checkpoint(os.path.join(out, "chkpnt3.pkl"))
    assert tp.app_net is not None and st.mu_app is not None
    net, emb = tapp.app_to_numpy(tp.app_net, tp.app_emb)
    adam = ttrain.adam_to_numpy(st)
    gauss = jgm.GaussianParams(*[getattr(tp.gauss, f).detach().numpy()
                                 for f in ttrain.GAUSS_FIELDS])
    jtp = jtrain.TrainParams(gauss=gauss, app_net=net, app_emb=emb)
    jst = jtrain.FusedAdamState(count=np.int32(adam.count), mu_flat=adam.mu_flat,
                                nu_flat=adam.nu_flat, mu_app=adam.mu_app, nu_app=adam.nu_app)
    jgs = jgm.GaussianState(*[getattr(gs, f).numpy() for f in ttrain.STATE_FIELDS])
    ckdir = str(tmp_path / "gof")
    os.makedirs(ckdir)
    jtrain.save_checkpoint(ckdir, 3, jtp, jst, jgs)
    path = os.path.join(ckdir, "chkpnt3.pkl")
    tp2, st2, gs2, it = ttrain.load_checkpoint(path)
    assert it == 3 and st2.count == st.count == 3
    for (k, a), b in zip(ttrain.app_leaves(tp).items(), ttrain.app_leaves(tp2).values()):
        assert torch.equal(a.detach(), b.detach()), k
        assert torch.equal(st.mu_app[k], st2.mu_app[k]) and torch.equal(st.nu_app[k],
                                                                        st2.nu_app[k]), k
    # gof_tpu reads it back too
    wtp, wst, _, _ = jtrain.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(wtp.app_emb), emb)

    out2 = str(tmp_path / "resumed")
    os.makedirs(out2)
    shutil.copy(path, out2)
    ttrain.main(["-s", synth_scene, "-m", out2, "--cpu", "--sh_degree", "1", "--kernel_size",
                 "0.1", "--use_decoupled_appearance", "--quiet", "--iterations", "5",
                 "--start_checkpoint", os.path.join(out2, "chkpnt3.pkl"),
                 "--checkpoint_iterations", "5"])
    tp3, st3, _, it3 = ttrain.load_checkpoint(os.path.join(out2, "chkpnt5.pkl"))
    assert it3 == 5 and st3.count == 5
    moved = [not torch.equal(a.detach(), b.detach()) for a, b in
             zip(ttrain.app_leaves(tp2).values(), ttrain.app_leaves(tp3).values())]
    assert all(moved)
