"""The port's `paddle.vision.ops` (paddle_tpu_torch/vision/ops.py) against
the JAX package's, on the CPU, on seeded inputs: every public function and
class, forward, and for the differentiable ones (`roi_align`, `roi_pool`,
`psroi_pool`, `deform_conv2d`, `yolo_loss`) the VJP of a seeded
cotangent against `jax.vjp`. Box arithmetic and the NMS index lists are
held exactly or to 1e-6; the sampled and contracted outputs and their
VJPs to rtol 1e-5 / atol 1e-6 (deform_conv2d's einsum, whose sums run in
another order, rtol 1e-4 / atol 1e-5). tests/test_detection_ops.py's
closed forms are held on the port too (zero offset is a conv, integer
offsets shift, a half mask halves, matrix NMS with exact duplicates and
across classes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.vision import ops as TV
from paddle_tpu_torch.weights import load_reference_layer

CLOSE = dict(rtol=1e-5, atol=1e-6)
EINSUM = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    before = tdevice.get_device()
    tp.set_device("cpu")
    yield
    tdevice._DEFAULT[0] = before


def _j(a):
    return jp.to_tensor(np.asarray(a))


def _np(t):
    if isinstance(t, (tuple, list)):
        return [_np(v) for v in t]
    if t is None:
        return None
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t._data)


def _tnp(t):
    if isinstance(t, (tuple, list)):
        return [_tnp(v) for v in t]
    return None if t is None else t._t.detach().numpy()


def _jitted(fn, *arrays):
    """The JAX op `fn` over `arrays` as one jitted program (numpy out)."""
    def run(*a):
        out = fn(*[jp.Tensor(x) for x in a])
        return jax.tree_util.tree_map(lambda t: t._data, out)
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(*arrays))


def _boxes(rng, n, size=32.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(2.0, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_public_names_resolve():
    want = {"nms", "box_area", "box_iou", "roi_align", "RoIAlign",
            "roi_pool", "RoIPool", "psroi_pool", "PSRoIPool",
            "deform_conv2d", "DeformConv2D", "yolo_box", "prior_box",
            "box_coder", "matrix_nms", "distribute_fpn_proposals",
            "generate_proposals", "yolo_loss"}
    ref = {n for n in dir(JV) if not n.startswith("_")
           and callable(getattr(JV, n)) and getattr(
               getattr(JV, n), "__module__", "") == JV.__name__}
    assert ref <= want <= set(TV.__all__)
    assert tp.vision.ops is TV and tp.vision.ops.nms is TV.nms


def test_box_area_and_iou():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_allclose(_tnp(TV.box_area(a)),
                               _np(JV.box_area(_j(a))), rtol=1e-6)
    np.testing.assert_allclose(_tnp(TV.box_iou(a, b)),
                               _np(JV.box_iou(_j(a), _j(b))), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(iou_threshold=0.3, top_k=9, categories=True),
    dict(iou_threshold=0.5, no_scores=True)])
def test_nms_keeps_the_reference_indices(kw):
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 40)
    scores = rng.rand(40).astype(np.float32)
    cats = rng.randint(0, 3, 40)
    args = dict(iou_threshold=kw["iou_threshold"], top_k=kw.get("top_k"))
    if not kw.get("no_scores"):
        args["scores"] = scores
    if kw.get("categories"):
        args["category_idxs"] = cats
    want = _np(JV.nms(_j(boxes), **{k: (_j(v) if isinstance(v, np.ndarray)
                                        else v) for k, v in args.items()}))
    got = _tnp(TV.nms(boxes, **args))
    np.testing.assert_array_equal(got, want)


def _vjp_pair(jfn, tfn, inputs, grad_of):
    """(forward, {name: gradient}) of the JAX and the port function on
    `inputs` (numpy), the VJP taken for the names in `grad_of` with a
    seeded cotangent."""
    rng = np.random.RandomState(7)
    names = list(inputs)

    def jf(*diff):
        vals = dict(inputs)
        vals.update(zip(grad_of, diff))
        out = jfn(*[jp.Tensor(jnp.asarray(vals[n])) if n in grad_of
                    else vals[n] for n in names])
        return out._data

    diff = [jnp.asarray(inputs[n]) for n in grad_of]
    cot = rng.standard_normal(jax.eval_shape(jf, *diff).shape).astype(
        np.float32)

    @jax.jit
    def forward_and_vjp(diff, cot):
        out, vjp = jax.vjp(jf, *diff)
        return out, vjp(cot)

    jout, jg = forward_and_vjp(diff, jnp.asarray(cot))
    jgrads = dict(zip(grad_of, (np.asarray(g) for g in jg)))
    leaves = {n: torch.tensor(inputs[n], requires_grad=True)
              for n in grad_of}
    tout = tfn(*[leaves[n] if n in grad_of else inputs[n] for n in names])
    (tout._t * torch.from_numpy(cot)).sum().backward()
    tgrads = {n: leaves[n].grad.numpy() for n in grad_of}
    return (np.asarray(jout), tout._t.detach().numpy()), (jgrads, tgrads)


def _roi_inputs(rng, c=3):
    x = rng.standard_normal((2, c, 16, 16)).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 2, 30.0), _boxes(rng, 3, 30.0)])
    return x, boxes, np.array([2, 3], np.int64)


@pytest.mark.parametrize("out,scale,ratio,aligned", [
    (4, 0.5, -1, True), ((3, 5), 0.5, 3, False), (2, 1.0, 2, True)])
def test_roi_align_and_its_vjp(out, scale, ratio, aligned):
    rng = np.random.RandomState(2)
    x, boxes, num = _roi_inputs(rng)
    inputs = dict(x=x, boxes=boxes, num=num)

    def call(V):
        return lambda x, b, n: V.roi_align(x, b, n, out, spatial_scale=scale,
                                           sampling_ratio=ratio,
                                           aligned=aligned)
    (jo, to), (jg, tg) = _vjp_pair(call(JV), call(TV), inputs, ["x"])
    np.testing.assert_allclose(to, jo, **CLOSE)
    np.testing.assert_allclose(tg["x"], jg["x"], **CLOSE)
    if ratio == -1:     # the layer's default sampling
        np.testing.assert_allclose(_tnp(TV.RoIAlign(out, scale)(
            x, boxes, num)), jo, **CLOSE)


@pytest.mark.parametrize("out,scale", [(4, 0.5), ((2, 3), 1.0)])
def test_roi_pool_and_its_vjp(out, scale):
    rng = np.random.RandomState(3)
    x, boxes, num = _roi_inputs(rng)

    def call(V):
        return lambda x, b, n: V.roi_pool(x, b, n, out, spatial_scale=scale)
    (jo, to), (jg, tg) = _vjp_pair(call(JV), call(TV),
                                   dict(x=x, boxes=boxes, num=num), ["x"])
    np.testing.assert_allclose(to, jo, **CLOSE)
    np.testing.assert_allclose(tg["x"], jg["x"], **CLOSE)
    np.testing.assert_allclose(_tnp(TV.RoIPool(out, scale)(x, boxes, num)),
                               jo, **CLOSE)


@pytest.mark.parametrize("out,scale", [(2, 0.5), ((3, 2), 1.0)])
def test_psroi_pool_and_its_vjp(out, scale):
    rng = np.random.RandomState(4)
    oh, ow = (out, out) if isinstance(out, int) else out
    x, boxes, num = _roi_inputs(rng, c=2 * oh * ow)

    def call(V):
        return lambda x, b, n: V.psroi_pool(x, b, n, out,
                                            spatial_scale=scale)
    (jo, to), (jg, tg) = _vjp_pair(call(JV), call(TV),
                                   dict(x=x, boxes=boxes, num=num), ["x"])
    np.testing.assert_allclose(to, jo, **CLOSE)
    np.testing.assert_allclose(tg["x"], jg["x"], **CLOSE)
    np.testing.assert_allclose(_tnp(TV.PSRoIPool(out, scale)(x, boxes,
                                                             num)),
                               jo, **CLOSE)


@pytest.mark.parametrize("kw", [
    dict(stride=1, padding=1, dilation=1, dg=1, groups=1, mask=False),
    dict(stride=1, padding=1, dilation=1, dg=2, groups=1, mask=True),
    dict(stride=2, padding=2, dilation=2, dg=2, groups=2, mask=True)])
def test_deform_conv2d_and_its_vjp(kw):
    rng = np.random.RandomState(5)
    c, cout, k = 4, 6, 3
    x = rng.standard_normal((2, c, 9, 9)).astype(np.float32)
    w = rng.standard_normal((cout, c // kw["groups"], k, k)).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ho = (9 + 2 * kw["padding"] - (kw["dilation"] * (k - 1) + 1)) \
        // kw["stride"] + 1
    off = (rng.standard_normal((2, 2 * kw["dg"] * k * k, ho, ho)) * 1.5
           ).astype(np.float32)
    mask = rng.rand(2, kw["dg"] * k * k, ho, ho).astype(np.float32)
    inputs = dict(x=x, off=off, w=w, b=b)
    if kw["mask"]:
        inputs["mask"] = mask

    def call(V):
        def f(x, off, w, b, mask=None):
            return V.deform_conv2d(x, off, w, b, stride=kw["stride"],
                                   padding=kw["padding"],
                                   dilation=kw["dilation"],
                                   deformable_groups=kw["dg"],
                                   groups=kw["groups"], mask=mask)
        return f
    (jo, to), (jg, tg) = _vjp_pair(call(JV), call(TV), inputs,
                                   list(inputs))
    np.testing.assert_allclose(to, jo, **EINSUM)
    for n in inputs:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **EINSUM)


def test_deform_conv2d_closed_forms():
    """tests/test_detection_ops.py's TestDeformConv2D on the port."""
    F = tp.nn.functional
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    zero = np.zeros((2, 18, 8, 8), np.float32)
    np.testing.assert_allclose(
        _tnp(TV.deform_conv2d(x, zero, w, padding=1)),
        _tnp(F.conv2d(tp.to_tensor(x), tp.to_tensor(w), padding=1)),
        atol=1e-4)
    x1 = rng.standard_normal((1, 1, 5, 5)).astype(np.float32)
    off = np.zeros((1, 2, 5, 5), np.float32)
    off[:, 1] = 1.0
    shifted = np.zeros_like(x1)
    shifted[..., :, :-1] = x1[..., :, 1:]
    np.testing.assert_allclose(
        _tnp(TV.deform_conv2d(x1, off, np.ones((1, 1, 1, 1), np.float32))),
        shifted, atol=1e-5)
    half = np.full((2, 9, 8, 8), 0.5, np.float32)
    np.testing.assert_allclose(
        _tnp(TV.deform_conv2d(x, zero, w, padding=1, mask=half)),
        _tnp(TV.deform_conv2d(x, zero, w, padding=1)) * 0.5, atol=1e-5)
    wg = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _tnp(TV.deform_conv2d(x, np.zeros((2, 18, 4, 4), np.float32), wg,
                              stride=2, padding=1, groups=2)),
        _tnp(F.conv2d(tp.to_tensor(x), tp.to_tensor(wg), stride=2,
                      padding=1, groups=2)), atol=1e-4)


def test_deform_conv2d_layer_carries_the_reference_weights():
    jp.seed(3)
    ref = JV.DeformConv2D(3, 5, 3, padding=1, deformable_groups=1)
    mine = TV.DeformConv2D(3, 5, 3, padding=1, deformable_groups=1)
    load_reference_layer(mine, {k: np.asarray(v._data) for k, v in
                                ref.state_dict().items()})
    assert [n for n, _ in mine.named_parameters()] == ["_conv.weight",
                                                       "_conv.bias"]
    assert [n for n, _ in ref.named_parameters()] == ["_conv.weight",
                                                      "_conv.bias"]
    rng = np.random.RandomState(8)
    x = rng.standard_normal((1, 3, 6, 6)).astype(np.float32)
    off = rng.standard_normal((1, 18, 6, 6)).astype(np.float32)
    want = _jitted(lambda x, o, w, b: JV.deform_conv2d(x, o, w, b,
                                                       padding=1),
                   x, off, ref.weight._data, ref.bias._data)
    np.testing.assert_allclose(_tnp(mine(tp.to_tensor(x),
                                         tp.to_tensor(off))), want,
                               **EINSUM)


@pytest.mark.parametrize("kw", [
    dict(), dict(clip_bbox=False, scale_x_y=1.05),
    dict(iou_aware=True, iou_aware_factor=0.4)])
def test_yolo_box(kw):
    rng = np.random.RandomState(9)
    an = 3
    ch = an * (5 + 4) + (an if kw.get("iou_aware") else 0)
    x = rng.standard_normal((2, ch, 4, 5)).astype(np.float32)
    img = np.array([[64, 80], [48, 60]], np.int64)
    anchors = [10, 13, 16, 30, 33, 23]
    want = _jitted(lambda x, i: JV.yolo_box(x, i, anchors, 4, 0.3, 16,
                                            **kw), x, img)
    got = TV.yolo_box(x, img, anchors, 4, 0.3, 16, **kw)
    for g, w in zip(_tnp(got), want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[4.0]),
    dict(min_sizes=[4.0, 8.0], max_sizes=[8.0, 12.0],
         aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    dict(min_sizes=[6.0], max_sizes=[10.0], aspect_ratios=[2.0],
         min_max_aspect_ratios_order=True, steps=(5.0, 4.0), offset=0.3)])
def test_prior_box(kw):
    feat = np.zeros((1, 8, 3, 4), np.float32)
    img = np.zeros((1, 3, 16, 20), np.float32)
    want = _jitted(lambda f, i: JV.prior_box(f, i, **kw), feat, img)
    got = TV.prior_box(feat, img, **kw)
    for g, w in zip(_tnp(got), want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_box_coder_encode_and_decode():
    rng = np.random.RandomState(10)
    priors = _boxes(rng, 4)
    gts = _boxes(rng, 3)
    var1 = np.float32([0.1, 0.1, 0.2, 0.2])
    var2 = rng.uniform(0.1, 0.3, (4, 4)).astype(np.float32)
    for var in (None, var1, var2):
        for normalized in (True, False):
            args = dict(code_type="encode_center_size",
                        box_normalized=normalized)
            want = _jitted(lambda p, g, *v: JV.box_coder(
                p, v[0] if v else None, g, **args), priors, gts,
                *([] if var is None else [var]))
            got = TV.box_coder(priors, var, gts, **args)
            np.testing.assert_allclose(_tnp(got), want, rtol=1e-5,
                                       atol=1e-6)
    deltas = (rng.standard_normal((4, 3, 4)) * 0.2).astype(np.float32)
    for axis, d in ((0, deltas), (1, deltas.transpose(1, 0, 2).copy())):
        for var in (None, var1, var2):
            args = dict(code_type="decode_center_size", axis=axis)
            want = _jitted(lambda p, t, *v: JV.box_coder(
                p, v[0] if v else None, t, **args), priors, d,
                *([] if var is None else [var]))
            got = TV.box_coder(priors, var, d, **args)
            np.testing.assert_allclose(_tnp(got), want, rtol=1e-5,
                                       atol=1e-5)


def _matrix_nms_pair(bxs, scs, *args, **kw):
    want = JV.matrix_nms(_j(bxs), _j(scs), *args, **kw)
    got = TV.matrix_nms(bxs, scs, *args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return _tnp(list(got)), _np(list(want))


@pytest.mark.parametrize("kw", [
    dict(use_gaussian=True, gaussian_sigma=2.0),
    dict(background_label=-1, return_index=True, nms_top_k=6,
         keep_top_k=5)])
def test_matrix_nms(kw):
    rng = np.random.RandomState(11)
    bxs = np.stack([_boxes(rng, 8), _boxes(rng, 8)])
    scs = rng.rand(2, 3, 8).astype(np.float32)
    args = dict(score_threshold=0.2, post_threshold=0.1, nms_top_k=-1,
                keep_top_k=-1)
    args.update(kw)
    got, want = _matrix_nms_pair(bxs, scs, **args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_matrix_nms_closed_forms():
    """Exact duplicates (no NaN, no over-suppression) and classes that do
    not suppress each other (tests/test_detection_ops.py)."""
    bxs = np.array([[[0, 0, 10, 10], [0, 0, 10, 10], [5, 0, 15, 10]]],
                   np.float32)
    scs = np.array([[[0.9, 0.8, 0.7]]], np.float32)
    got, want = _matrix_nms_pair(bxs, scs, 0.1, 0.2, 3, 3,
                                 background_label=-1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    kept = sorted(got[0][:, 1].tolist(), reverse=True)
    assert np.isfinite(got[0]).all() and abs(kept[0] - 0.9) < 1e-6
    assert any(abs(s - 0.7 * (2 / 3)) < 1e-5 for s in kept)
    bxs = np.array([[[0, 0, 10, 10], [0, 0, 10, 10]]], np.float32)
    scs = np.array([[[0.9, 0.0], [0.0, 0.8]]], np.float32)
    got, want = _matrix_nms_pair(bxs, scs, 0.1, 0.5, 4, 4,
                                 background_label=-1)
    assert got[1].tolist() == want[1].tolist() == [2]


def test_distribute_fpn_proposals():
    rng = np.random.RandomState(12)
    side = rng.choice([8.0, 20.0, 60.0, 130.0, 300.0], 12)
    xy = rng.uniform(0, 50, (12, 2))
    rois = np.concatenate([xy, xy + side[:, None]], 1).astype(np.float32)
    for offset in (False, True):
        want = JV.distribute_fpn_proposals(
            _j(rois), 2, 5, 4, 224, pixel_offset=offset,
            rois_num=_j(np.array([12])))
        got = TV.distribute_fpn_proposals(rois, 2, 5, 4, 224,
                                          pixel_offset=offset,
                                          rois_num=np.array([12]))
        for g, w in zip(_tnp(got[0]), _np(want[0])):
            np.testing.assert_array_equal(g, w)
        assert [int(n) for n in _tnp(got[1])] == [int(n) for n in
                                                  _np(want[1])]
        np.testing.assert_array_equal(_tnp(got[2]), _np(want[2]))


@pytest.mark.parametrize("batched", [False, True])
def test_generate_proposals(batched):
    rng = np.random.RandomState(13)
    h = w = 5
    a = 3
    scores = rng.rand(2, a, h, w).astype(np.float32)
    deltas = (rng.standard_normal((2, 4 * a, h, w)) * 0.2).astype(
        np.float32)
    anchors = _boxes(rng, h * w * a, 48.0).reshape(h, w, a, 4)
    var = np.ones((h, w, a, 4), np.float32)
    img = np.array([[64.0, 64.0], [56.0, 60.0]], np.float32)
    if not batched:
        scores, deltas, img = scores[0], deltas[0], img[0]
    kw = dict(pre_nms_top_n=40, post_nms_top_n=10, nms_thresh=0.5,
              min_size=1.0, return_rois_num=True)
    want = JV.generate_proposals(_j(scores), _j(deltas), _j(img),
                                 _j(anchors), _j(var), **kw)
    got = TV.generate_proposals(scores, deltas, img, anchors, var, **kw)
    for g, w in zip(_tnp(got), _np(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True)])
def test_yolo_loss_and_its_vjp(smooth, score):
    rng = np.random.RandomState(14)
    n, cls, h, w = 2, 3, 6, 6
    mask = [0, 1, 2]
    x = rng.standard_normal((n, len(mask) * (5 + cls), h, w)).astype(
        np.float32)
    # gt boxes in distinct cells (away from cell (0, 0)); the last slot
    # of each image is padding
    gt = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2],
                    [0.55, 0.25, 0.1, 0.1], [0, 0, 0, 0]],
                   [[0.5, 0.5, 0.6, 0.5], [0.2, 0.8, 0.15, 0.2],
                    [0.85, 0.35, 0.3, 0.4], [0, 0, 0, 0]]], np.float32)
    label = np.array([[0, 2, 1, 0], [1, 1, 2, 0]], np.int64)
    gscore = rng.uniform(0.5, 1.0, (n, 4)).astype(np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    inputs = dict(x=x, gt=gt, label=label)
    if score:
        inputs["gscore"] = gscore

    def call(V):
        def f(x, gt, label, gscore=None):
            return V.yolo_loss(x, gt, label, anchors, mask, cls, 0.5, 32,
                               gt_score=gscore, use_label_smooth=smooth)
        return f
    (jo, to), (jg, tg) = _vjp_pair(call(JV), call(TV), inputs, ["x"])
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg["x"], jg["x"], **CLOSE)
