"""The port's `paddle.save` / `paddle.load`, hapi (`paddle.Model`, the
callbacks, `summary`, `flops`) and `paddle.vision` (transforms, the
synthetic datasets, LeNet, ResNet) against the JAX package's, on the CPU.

- save / load round-trips nested state over Tensors (types, names,
  `return_numpy`, file objects, an optimizer's state), and each package
  loads the state dicts (bfloat16 too) that the other saved;
- `Model` prepare / fit / evaluate / predict / save / load / summary /
  flops and the callbacks, after tests/test_hapi_vision.py;
- LeNet through `Model.fit` at fp32 over the seeded synthetic MNIST with
  `shuffle=False`: every batch's loss (rtol 1e-4) and the final
  parameters (atol 1e-5) against the JAX `Model.fit` from the same
  weights;
- a BottleneckBlock ResNet (depth 50, 10 classes) on a 4 x 3 x 32 x 32
  batch: one `Model.train_batch` with Momentum(0.1, 0.9, L2Decay(1e-4)),
  its loss, the parameters after the update and the BatchNorm running
  statistics as close to a float64 step as the reference's jitted step
  is, within a factor of 2 (see the test for why);
- the transforms and the synthetic datasets give the reference's arrays.
"""
import io
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.weights import load_reference_layer
from _reference_init import numpy_init

pytestmark = pytest.mark.filterwarnings("ignore:.*synthetic.*")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
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


def _lenet_model(pkg, net=None, lr=1e-3):
    net = net or pkg.vision.LeNet()
    model = pkg.Model(net)
    model.prepare(pkg.optimizer.Adam(learning_rate=lr,
                                     parameters=net.parameters()),
                  pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
    return model


def _separable(n=256, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, (n, 1))
    x = (labels.reshape(-1, 1, 1, 1) / 10.0
         + 0.05 * rng.randn(n, 1, 28, 28)).astype("float32")
    return x, labels


# ------------------------------------------------------------ save / load
def test_save_load_roundtrip(tmp_path):
    w = tp.to_tensor(np.arange(6, dtype="float32").reshape(2, 3))
    w.name = "w0"
    obj = {"w": w, "half": w.astype("bfloat16"),
           "meta": {"lr": 0.1, "steps": [1, 2], "pair": (3, w)}}
    path = os.path.join(str(tmp_path), "sub", "obj.pd")
    tp.save(obj, path)
    back = tp.load(path)
    np.testing.assert_array_equal(back["w"].numpy(), w.numpy())
    assert back["w"].name == "w0" and back["half"].dtype == tp.bfloat16
    assert back["meta"]["lr"] == 0.1 and back["meta"]["steps"] == [1, 2]
    assert isinstance(back["meta"]["pair"], tuple)
    arrays = tp.load(path, return_numpy=True)
    assert isinstance(arrays["w"], np.ndarray)
    buf = io.BytesIO()
    tp.save(w, buf)
    buf.seek(0)
    np.testing.assert_array_equal(tp.load(buf).numpy(), w.numpy())


def test_save_load_reads_the_references_state_dict(tmp_path):
    """A state dict that the JAX package saved loads into the port's
    layer, and one that the port saved loads into the JAX layer, by name
    and with the same values; bfloat16 crosses both ways."""
    with numpy_init(1):
        ref = jp.vision.LeNet()
    path = os.path.join(str(tmp_path), "ref.pdparams")
    jp.save(ref.state_dict(), path)
    mine = tp.vision.LeNet()
    mine.set_state_dict(tp.load(path))
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(mine.state_dict()[k].numpy(),
                                      v.numpy())
    with numpy_init(2):
        other = jp.vision.LeNet()
    path = os.path.join(str(tmp_path), "mine.pdparams")
    tp.save(mine.state_dict(), path)
    other.set_state_dict(jp.load(path))
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(),
                                      v.numpy())
    x = np.linspace(-3, 3, 12, dtype="float32").reshape(3, 4)
    path = os.path.join(str(tmp_path), "half.pd")
    jp.save({"h": jp.to_tensor(x).astype("bfloat16")}, path)
    half = tp.load(path)["h"]
    assert half.dtype == tp.bfloat16
    want = tp.to_tensor(x).astype("bfloat16")
    assert torch.equal(half._t, want._t)
    tp.save({"h": want}, path)
    np.testing.assert_array_equal(
        np.asarray(jp.load(path)["h"].numpy(), np.float32),
        want._t.float().numpy())


def test_optimizer_state_roundtrip(tmp_path):
    net = tp.nn.Linear(3, 2)
    opt = tp.optimizer.Adam(1e-2, parameters=net.parameters())
    net(tp.to_tensor(np.ones((4, 3), "float32"))).sum().backward()
    opt.step()
    path = os.path.join(str(tmp_path), "opt.pdopt")
    tp.save(opt.state_dict(), path)
    opt2 = tp.optimizer.Adam(1e-2, parameters=net.parameters())
    opt2.set_state_dict(tp.load(path))
    assert opt2._step_count == 1
    for k, v in opt.state_dict().items():
        if k != "@step_count":
            np.testing.assert_array_equal(opt2.state_dict()[k].numpy(),
                                          v.numpy())


# ------------------------------------------------------------------ Model
def test_model_fit_loss_decreases():
    x, labels = _separable()
    ds = tp.io.TensorDataset([tp.to_tensor(x), tp.to_tensor(labels)])
    model = _lenet_model(tp)
    loss0 = float(model.train_batch([x[:64]], [labels[:64]])[0][0])
    model.fit(ds, batch_size=64, epochs=3, verbose=0, shuffle=True,
              drop_last=True)
    last = model.eval_batch([x[:64]], [labels[:64]])
    assert float(last[0][0]) < loss0
    assert 0.0 <= last[1][0] <= 1.0


def test_model_evaluate_predict():
    model = _lenet_model(tp)
    x = np.random.rand(16, 1, 28, 28).astype("float32")
    y = np.random.randint(0, 10, (16, 1))
    ds = tp.io.TensorDataset([tp.to_tensor(x), tp.to_tensor(y)])
    res = model.evaluate(ds, batch_size=8, verbose=0)
    assert "loss" in res and "acc" in res
    preds = model.predict(ds, batch_size=8, stack_outputs=True, verbose=0)
    assert preds[0].shape == (16, 10)
    np.testing.assert_allclose(
        preds[0], model.network(tp.to_tensor(x)).numpy(), rtol=1e-5,
        atol=1e-6)


def test_model_save_load(tmp_path):
    model = _lenet_model(tp)
    x = np.random.rand(8, 1, 28, 28).astype("float32")
    y = np.random.randint(0, 10, (8, 1))
    model.train_batch([x], [y])
    path = os.path.join(str(tmp_path), "ck", "model")
    model.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    model2 = _lenet_model(tp)
    model2.load(path)
    for a, b in zip(model.parameters(), model2.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert model2._optimizer._step_count == 1
    # both take the same next step
    for m in (model, model2):
        m.train_batch([x], [y])
    for a, b in zip(model.parameters(), model2.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


def test_summary_and_flops_match_the_reference(capsys):
    with numpy_init(2):
        ref = jp.vision.LeNet()
    mine = tp.vision.LeNet()
    want = jp.summary(ref, (1, 1, 28, 28))
    got = tp.summary(mine, (1, 1, 28, 28))
    assert got == want
    assert "Total params: 61,610" in capsys.readouterr().out
    assert tp.flops(mine, [1, 1, 28, 28]) == jp.flops(ref, (1, 1, 28, 28))
    assert _lenet_model(tp, mine).summary((1, 1, 28, 28)) == want
    mine.train()
    tp.flops(mine, [1, 1, 28, 28])
    assert mine.training


def test_callbacks(tmp_path, capsys):
    """ProgBarLogger prints, ModelCheckpoint saves each epoch and the end,
    LRScheduler steps the scheduler every batch, VisualDL writes its
    scalars, EarlyStopping stops a run whose monitored value stops
    improving."""
    from paddle_tpu_torch.hapi import callbacks as C

    x, labels = _separable(64)
    ds = tp.io.TensorDataset([tp.to_tensor(x), tp.to_tensor(labels)])
    net = tp.vision.LeNet()
    sched = tp.optimizer.lr.StepDecay(1e-3, step_size=2, gamma=0.5)
    model = tp.Model(net)
    model.prepare(tp.optimizer.Adam(sched, parameters=net.parameters()),
                  tp.nn.CrossEntropyLoss(), tp.metric.Accuracy())
    save_dir = os.path.join(str(tmp_path), "ck")
    log_dir = os.path.join(str(tmp_path), "vdl")
    model.fit(ds, batch_size=16, epochs=2, save_dir=save_dir, verbose=2,
              log_freq=2, callbacks=[C.VisualDL(log_dir)])
    out = capsys.readouterr().out
    assert "Epoch 1/2" in out and "step 4/4" in out
    for sub in ("0", "1", "final"):
        assert os.path.exists(os.path.join(save_dir, sub,
                                           "model.pdparams"))
    assert sched.last_epoch == 8
    lines = open(os.path.join(log_dir, "scalars.jsonl")).read().splitlines()
    assert len(lines) == 8 and '"acc"' in lines[0]
    stop = C.EarlyStopping(monitor="loss", patience=0, verbose=0,
                           save_best_model=False)
    stop.set_model(model)
    stop.on_train_begin()
    stop.on_eval_end({"loss": [1.0]})
    stop.on_eval_end({"loss": [2.0]})
    assert model.stop_training
    cbks = C.config_callbacks(model=model, verbose=0, epochs=1, steps=2)
    kinds = {type(c).__name__ for c in cbks}
    assert kinds == {"LRScheduler"}


def test_model_prepare_checks_and_amp_context():
    model = tp.Model(tp.vision.LeNet())
    with pytest.raises(TypeError):
        model.prepare(loss=3)
    with pytest.raises(TypeError):
        model.prepare(metrics=[object()])
    with pytest.raises(RuntimeError):
        model.train_batch([np.zeros((1, 1, 28, 28), "float32")])
    model.prepare(amp_configs={"level": "O2", "dtype": "bfloat16"})
    out = model.predict_batch([np.zeros((2, 1, 28, 28), "float32")])
    assert out[0].shape == (2, 10)
    trained = _lenet_model(tp)
    x, y = np.zeros((2, 1, 28, 28), "float32"), np.zeros((2, 1), "int64")
    with pytest.raises(NotImplementedError):        # as the reference
        trained.train_batch([x], [y], update=False)
    with pytest.raises(NotImplementedError):
        trained.fit([([x], [y])], accumulate_grad_batches=2, verbose=0)


# --------------------------------------------- LeNet parity with the JAX fit
class _Losses:
    """A callback recording every train batch's loss."""

    def __init__(self, base):
        self.__class__ = type("Recorder", (base,), {
            "on_train_batch_end": lambda self, step, logs=None:
            self.seen.append(logs["loss"][0])})
        base.__init__(self)
        self.seen = []


def _mnist(pkg, n):
    ds = pkg.vision.datasets.MNIST(
        mode="train", transform=pkg.vision.transforms.ToTensor())
    return pkg.io.Subset(ds, list(range(n)))


def test_lenet_fit_matches_the_reference():
    jp.seed(11)
    ref_net = jp.vision.LeNet()
    mine_net = tp.vision.LeNet()
    load_reference_layer(mine_net, ref_net.state_dict())
    runs = {}
    for name, pkg, net in (("ref", jp, ref_net), ("mine", tp, mine_net)):
        model = _lenet_model(pkg, net)
        rec = _Losses(pkg.hapi.callbacks.Callback)
        model.fit(_mnist(pkg, 80), batch_size=16, epochs=2, shuffle=False,
                  drop_last=True, verbose=0, callbacks=[rec])
        runs[name] = rec.seen
    assert len(runs["mine"]) == len(runs["ref"]) == 10
    np.testing.assert_allclose(runs["mine"], runs["ref"], rtol=1e-4)
    assert runs["mine"][-1] < runs["mine"][0]
    want = ref_net.state_dict()
    for k, v in mine_net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)


# --------------------------------------- ResNet step parity with the JAX step
def _float64_step(net, x, y, lr, momentum, decay):
    """The ResNet's Model.train_batch in float64 with torch ops: the
    loss, the parameters after one Momentum step with coupled L2 decay,
    and the BatchNorm running statistics (momentum 0.9, biased batch
    variance)."""
    F, d = torch.nn.functional, torch.float64
    params = {k: p._t.detach().to(d).requires_grad_()
              for k, p in net.named_parameters()}
    buffers = {k: b._t.detach().to(d).clone()
               for k, b in net.named_buffers()}

    def conv(name, c, t):
        return F.conv2d(t, params[f"{name}.weight"], None, c.stride,
                        c.padding, c.dilation, c.groups)

    def bn(name, t):
        mean = t.mean((0, 2, 3))
        var = ((t - mean[None, :, None, None]) ** 2).mean((0, 2, 3))
        for key, batch in (("_mean", mean), ("_variance", var)):
            run = buffers[f"{name}.{key}"]
            buffers[f"{name}.{key}"] = 0.9 * run + 0.1 * batch.detach()
        norm = (t - mean[None, :, None, None]) / torch.sqrt(
            var[None, :, None, None] + 1e-5)
        return norm * params[f"{name}.weight"][None, :, None, None] \
            + params[f"{name}.bias"][None, :, None, None]

    t = torch.from_numpy(x).to(d)
    t = torch.relu(bn("bn1", conv("conv1", net.conv1, t)))
    t = F.max_pool2d(F.pad(t, [1, 1, 1, 1], value=float("-inf")), 3, 2)
    for li in range(1, 5):
        for bi, blk in enumerate(getattr(net, f"layer{li}")):
            pre = f"layer{li}.{bi}"
            out = t
            for j in (1, 2, 3):
                out = bn(f"{pre}.bn{j}", conv(f"{pre}.conv{j}",
                                              getattr(blk, f"conv{j}"), out))
                out = torch.relu(out) if j < 3 else out
            if blk.downsample is not None:
                t = bn(f"{pre}.downsample.1", conv(
                    f"{pre}.downsample.0", blk.downsample[0], t))
            t = torch.relu(out + t)
    logits = t.mean((2, 3)) @ params["fc.weight"] + params["fc.bias"]
    loss = F.cross_entropy(logits, torch.from_numpy(y[:, 0]))
    grads = torch.autograd.grad(loss, list(params.values()))
    new = {k: (p - lr * (g + decay * p)).detach()
           for (k, p), g in zip(params.items(), grads)}
    return float(loss.detach()), {**new, **buffers}


def test_bottleneck_resnet_step_matches_the_reference():
    """One step at 32 x 32 and batch 4 leaves layer4 (1 x 1 maps) with
    BatchNorm over 4 values a channel, which magnifies rounding into the
    gradients: after the step the reference's own fp32 parameters sit a
    median ~1-3% of each tensor's scale from a float64 step's, its loss up
    to ~1e-3 of the loss. So the port is held to the float64 step as
    close as the reference is, within a factor of 2 for seed to seed
    spread: the loss within 3x the reference's distance or 1e-3 of the
    loss; over the parameters and running statistics, the summed
    worst-entry distances within 2x the reference's and the median ratio
    of the two distances below 2. A wrong formula moves them by O(1)."""
    build = lambda pkg: pkg.vision.models.ResNet(
        pkg.vision.models.resnet.BottleneckBlock, 50, num_classes=10)
    with numpy_init(5):
        ref_net = build(jp)
    mine_net = build(tp)
    load_reference_layer(mine_net, ref_net.state_dict())
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3, 32, 32).astype("float32")
    y = rng.randint(0, 10, (4, 1))
    true_loss, true_state = _float64_step(mine_net, x, y, 0.1, 0.9, 1e-4)
    losses = {}
    for name, pkg, net in (("ref", jp, ref_net), ("mine", tp, mine_net)):
        opt = pkg.optimizer.Momentum(
            0.1, 0.9, parameters=net.parameters(),
            weight_decay=pkg.optimizer.L2Decay(1e-4))
        model = pkg.Model(net)
        model.prepare(opt, pkg.nn.CrossEntropyLoss())
        losses[name] = float(model.train_batch([x], [y])[0])
    e_ref = abs(losses["ref"] - true_loss)
    assert abs(losses["mine"] - true_loss) <= max(
        3 * e_ref, 1e-3 * abs(true_loss)), (losses, true_loss)
    want = ref_net.state_dict()
    mine = mine_net.state_dict()
    assert list(mine) == list(want) == list(true_state)
    dist = {k: (np.abs(mine[k].numpy() - true_state[k].numpy()).max(),
                np.abs(want[k].numpy() - true_state[k].numpy()).max())
            for k in mine}
    got, ref = (sum(d[i] for d in dist.values()) for i in (0, 1))
    assert got <= 2 * ref, (got, ref)
    ratios = [a / max(b, 1e-9) for a, b in dist.values()]
    assert np.median(ratios) < 2, np.median(ratios)


# -------------------------------------------------- transforms, datasets
@pytest.mark.parametrize("cls,mode", [
    ("MNIST", "train"), ("FashionMNIST", "test"), ("Cifar10", "test"),
    ("Cifar100", "train"), ("Flowers", "valid")])
def test_synthetic_datasets_equal_the_reference(cls, mode):
    mine = getattr(tp.vision.datasets, cls)(mode=mode)
    ref = getattr(jp.vision.datasets, cls)(mode=mode)
    assert len(mine) == len(ref)
    np.testing.assert_array_equal(mine.images, ref.images)
    np.testing.assert_array_equal(mine.labels, ref.labels)
    img, label = mine[3]
    assert img.shape == ref[3][0].shape and int(label) == int(ref[3][1])


def test_dataset_folder(tmp_path):
    for c in ("cat", "dog"):
        os.makedirs(os.path.join(str(tmp_path), c))
        for i in range(2):
            np.save(os.path.join(str(tmp_path), c, f"{i}.npy"),
                    np.full((4, 4, 3), i, np.uint8))
    mine = tp.vision.datasets.DatasetFolder(str(tmp_path))
    ref = jp.vision.datasets.DatasetFolder(str(tmp_path))
    assert mine.classes == ref.classes == ["cat", "dog"]
    assert [s[1] for s in mine.samples] == [s[1] for s in ref.samples]
    np.testing.assert_array_equal(mine[3][0], ref[3][0])
    assert len(tp.vision.datasets.ImageFolder(str(tmp_path))) == 4


def _pipeline(T):
    return T.Compose([
        T.Resize((30, 26)), T.RandomHorizontalFlip(0.5), T.CenterCrop(24),
        T.Pad(2), T.RandomCrop(22), T.ColorJitter(0.2, 0.2, 0.2),
        T.ToTensor(), T.Normalize(mean=[0.5] * 3, std=[0.5] * 3)])


def test_transforms_equal_the_reference():
    img = (np.random.RandomState(0).rand(32, 36, 3) * 255).astype(np.uint8)
    outs = []
    for T in (tp.vision.transforms, jp.vision.transforms):
        random.seed(4)
        np.random.seed(4)
        outs.append(_pipeline(T)(img).numpy())
    assert outs[0].shape == (3, 22, 22)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    T, J = tp.vision.transforms, jp.vision.transforms
    for fn, args in (("resize", (10,)), ("center_crop", (16,)),
                     ("pad", (2,)), ("to_grayscale", ()), ("hflip", ()),
                     ("rotate", (30,)), ("adjust_brightness", (1.3,))):
        np.testing.assert_array_equal(getattr(T, fn)(img, *args),
                                      getattr(J, fn)(img, *args))
    t = T.ToTensor()(img)
    assert t.place.is_cpu_place() and t.dtype == tp.float32


def test_vision_models_and_later_names():
    net = tp.vision.models.resnet18(num_classes=10)
    net.eval()
    assert net(tp.to_tensor(np.random.rand(2, 3, 32, 32).astype(
        "float32"))).shape == [2, 10]
    assert sum(p.numel() for p in tp.vision.models.resnet50(
        ).parameters()) == 25557032
    for ctor in ("resnext50_32x4d", "wide_resnet50_2"):
        assert len(getattr(tp.vision.models, ctor)(
            num_classes=4).parameters()) > 0
    with pytest.raises(RuntimeError):
        tp.vision.models.resnet18(pretrained=True)
    for name in ("vgg16", "mobilenet_v2", "AlexNet"):
        assert callable(getattr(tp.vision.models, name))
        assert getattr(tp.vision, name) is getattr(tp.vision.models, name)
    assert callable(tp.vision.ops.nms)
    net = tp.vision.LeNet()
    model = tp.Model(tp.DataParallel(net))
    assert model.network._layers is net and model._group is None
    assert isinstance(tp.vision.LeNet(), torch.nn.Module)
