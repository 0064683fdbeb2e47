"""Train the paper's VGG-16 SNN (reduced) at a chosen precision with
surrogate-gradient BPTT + threshold balancing, then deploy the SAME model
graph through the one-shot packed integer pipeline: the PyTorch port
(``repro_torch``) of ``examples/train_quantized_snn.py``, step for step.

Training lowers the graph with the float/BPTT executor (QAT fake-quant at
2/4/8 bits); deployment packs every post-stem layer once (weights and
folded per-channel thresholds) and serves it through the fused CUDA
kernels, bit-exact with the per-call integer path (asserted below).

Run:  PYTHONPATH=src python examples/train_quantized_snn_torch.py [--bits 4]
      (--smoke shrinks steps/geometry; --device cpu runs the plain
      PyTorch versions of the kernels on the CPU, the default is the GPU)
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.lif import LIFConfig
from repro_torch.data import synthetic
from repro_torch.deploy import deploy
from repro_torch.device import resolve_device
from repro_torch.graph import build_graph
from repro_torch.models import snn_cnn
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, unflatten_like


def ce(params, cfg, x, y):
    """Mean cross-entropy of the float/BPTT forward's logits."""
    logits = snn_cnn.apply(params, cfg, x)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - logits.gather(1, y[:, None])[:, 0])


def train_step(params, state, x, y, cfg, ocfg):
    """One BPTT step: surrogate gradients of :func:`ce` (zeros for a leaf
    the loss does not reach: the head's gain), then AdamW (in place).
    Returns the loss."""
    loss = ce(params, cfg, x, y)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    opt.update(unflatten_like(params, list(grads)), state, params, ocfg)
    return loss.detach()


def accuracy(logits, y) -> float:
    return float((logits.argmax(-1).cpu() == torch.as_tensor(y)).float()
                 .mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=4, choices=(2, 4, 8, 16))
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 120, 12 with --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI geometry: few steps, tiny model")
    ap.add_argument("--fusion", default="off", choices=("off", "auto"),
                    help="deploy with planner-proposed multi-layer fusion "
                         "groups (repro_torch.graph.fusion)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    steps = args.steps if args.steps is not None else (
        12 if args.smoke else 120)
    pc = PrecisionConfig(bits=args.bits, group_size=-1) if args.bits != 16 \
        else PrecisionConfig(bits=16)
    cfg = snn_cnn.SNNConfig(model="vgg16", img_size=16, timesteps=3,
                            scale=0.15 if args.smoke else 0.25,
                            n_classes=10, precision=pc,
                            lif=LIFConfig(leak_shift=3, threshold=0.5))
    print(build_graph(cfg).summary())  # the one topology every lowering uses
    (x_tr, y_tr), (x_te, y_te) = synthetic.make_vision_dataset(
        n_classes=10, img_size=16, n_train=256 if args.smoke else 1024,
        n_test=64 if args.smoke else 256)

    def batch(x, y=None):
        xb = torch.from_numpy(x).to(dev)
        return xb if y is None else (xb, torch.from_numpy(y).to(
            dev, torch.int64))

    params = snn_cnn.init(0, cfg, device=dev)
    params = snn_cnn.calibrate(params, cfg, batch(x_tr[:32]))
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    state = opt.init(params)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                         weight_decay=0.0, clip_norm=5.0)

    t0 = time.time()
    losses = []
    for i in range(steps):
        j = (i * 64) % (len(x_tr) - 64)
        loss = train_step(params, state, *batch(x_tr[j:j + 64],
                                                y_tr[j:j + 64]), cfg, ocfg)
        losses.append(float(loss))
        if i % 20 == 0:
            print(f"step {i:4d} loss {losses[-1]:.3f} "
                  f"({time.time()-t0:.0f}s)")

    with torch.no_grad():
        acc = accuracy(snn_cnn.apply(params, cfg, batch(x_te)), y_te)
    print(f"\nW{args.bits} (QAT forward) test accuracy: {acc*100:.1f}%")

    # deployment: lower the SAME graph to the packed integer datapath, once.
    # bits=16 trains unquantized; deploy it at INT8 (PTQ).
    deploy_bits = args.bits if args.bits != 16 else 8
    int_cfg = dataclasses.replace(
        cfg, int_deploy=True, precision=PrecisionConfig(bits=deploy_bits),
        fusion="auto" if args.fusion == "auto" else ())
    if int_cfg.fusion:
        groups = build_graph(int_cfg).groups
        print(f"fusion: {len(groups)} group(s): "
              + "; ".join(f"{g.name}={'+'.join(g.members)}" for g in groups))
    t0 = time.time()
    model = deploy(params, int_cfg, device=dev)
    print(f"deployed W{deploy_bits} in {time.time()-t0:.2f}s: "
          f"{len(model.layers)} packed layers, "
          f"{model.nbytes_packed()/1e6:.3f} MB "
          f"({model.compression_ratio():.1f}x vs fp32)")

    # the packaged forward must be bit-exact with the per-call integer path
    xb = batch(x_te[:32])
    with torch.no_grad():
        percall = snn_cnn.apply(params, int_cfg, xb)
        packaged = model.apply(xb)
    np.testing.assert_array_equal(
        packaged.cpu().numpy(), percall.cpu().numpy(),
        err_msg="packaged forward desyncs the per-call integer path")
    print("packaged forward == per-call integer forward (bit-exact)")

    # fusion groups are a lowering strategy, not a numeric change: the
    # grouped forward must match the ungrouped one bit for bit
    if int_cfg.fusion:
        with torch.no_grad():
            ungrouped = snn_cnn.apply(
                params, dataclasses.replace(int_cfg, fusion=()), xb)
        np.testing.assert_array_equal(
            percall.cpu().numpy(), ungrouped.cpu().numpy(),
            err_msg="fusion groups changed the integer forward")
        print("grouped forward == ungrouped forward (bit-exact)")

    with torch.no_grad():
        int_acc = accuracy(model.apply(batch(x_te)), y_te)
    print(f"deployed INT{deploy_bits} test accuracy: {int_acc*100:.1f}% "
          f"(packed integer datapath, zero per-call quantization)")
    return {"losses": losses, "qat_acc": acc, "int_acc": int_acc,
            "model": model}


if __name__ == "__main__":
    main()
