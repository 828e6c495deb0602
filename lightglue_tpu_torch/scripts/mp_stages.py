"""ALIKED at mp, the card against the CPU port, stage by stage: where the
two score maps part.

    python -m lightglue_tpu_torch.scripts.mp_stages

On chip_smoke.py's phase-5f ALIKED image (aliked-n16, seeded random
weights, 768 x 1024, the lazy path with B10). Each stage runs on the card
fed the CPU's input and is compared with the CPU's output: the share of
outputs unequal, the share more than one bf16 step apart, the largest
difference. Inside block 3 (the first deformable block): its offset conv,
its deformable conv given the CPU's offsets, the batch norm and the SELU.
Then four of the convolutions, each against one rounding of its exact
(float64) sum: cuDNN's bf16 convolution, cuDNN's fp32 convolution of the
bf16 operands rounded, the CPU's rounded. Last, the whole score map, and
the map with blocks 3 and 4 taken from the CPU. Needs a GPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..models import aliked as al
from ..ops import aliked_stem, deform
from ..synthetic import image_pair
from . import keypoint_margins as km
from .extract_times import aliked_params

BF = torch.bfloat16


def compare(tag: str, card: torch.Tensor, cpu: torch.Tensor) -> None:
    """One line: the card's output against the CPU's (steps of bf16 for a
    bf16 output, of fp32 for an fp32 one)."""
    a = card.detach().float().cpu().double()
    b = cpu.detach().float().double()
    u = km.ulp(b, cpu.dtype if cpu.dtype == BF else torch.float32)
    d = (a - b).abs() / u
    print(f"  {tag:40s} unequal {float((a != b).double().mean()):.3e}, "
          f"> 1 step {float((d > 1.0).double().mean()):.3e}, largest "
          f"{float((a - b).abs().max()):.3e}", flush=True)


def against_exact(tag: str, w: torch.Tensor, x: torch.Tensor) -> None:
    """A bf16 convolution (SAME, no bias) of the card's x three ways, each
    against its exact sum rounded once to bf16: the share unequal."""
    pad, wb = w.shape[-1] // 2, w.to(BF)
    exact = F.conv2d(x.double(), wb.double(), padding=pad).to(BF).cpu()
    with nn.fp32_convs():
        ways = (("cuDNN bf16", F.conv2d(x, wb, padding=pad)),
                ("cuDNN fp32, rounded",
                 F.conv2d(x.float(), wb.float(), padding=pad).to(BF)),
                ("CPU fp32, rounded", F.conv2d(
                    x.float().cpu(), wb.float().cpu(), padding=pad).to(BF)))
    line = ", ".join(f"{name} {float((v.cpu() != exact).float().mean()):.3e}"
                     for name, v in ways)
    print(f"  {tag:28s} unequal to the exact sum rounded: {line}",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mp_stages needs a GPU")
    gp = aliked_params("aliked-n16", "cuda")
    cp = nn.params_to(gp, "cpu")
    g = image_pair(np.random.default_rng(83), 768, 1024)[0]
    rgb = np.stack([g, np.sqrt(g), g * g], -1).astype(np.float32)
    x = torch.from_numpy(rgb)[None].permute(0, 3, 1, 2).contiguous().to(BF)
    c = lambda t: t.cuda()  # noqa: E731
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}")
    with torch.inference_mode():
        print("each stage on the card, fed the CPU's input:")
        stem_p = lambda p: {"block1": p["block1"], "conv1": p["conv1"]}  # noqa: E731
        y1, x1p = aliked_stem.fused_aliked_stem(stem_p(cp), x)
        gy1, gx1p = aliked_stem.fused_aliked_stem(stem_p(gp), c(x))
        compare("B10 y1", gy1, y1)
        compare("B10 x1p", gx1p, x1p)
        x2 = al._res_block(cp["block2"], x1p, False)
        compare("block 2", al._res_block(gp["block2"], c(x1p), False), x2)
        x3in = nn.avg_pool(x2, 4)
        x3 = al._res_block(cp["block3"], x3in, True)
        compare("block 3 (deformable)",
                al._res_block(gp["block3"], c(x3in), True), x3)
        p3, g3 = cp["block3"]["conv1"], gp["block3"]["conv1"]
        with nn.fp32_convs():
            off = nn.conv2d(p3["offset_conv"], x3in)
            compare("  its offset conv", nn.conv2d(g3["offset_conv"], c(x3in)),
                    off)
            lim = max(x3in.shape[2:]) / 4.0
            off = off.clamp(-lim, lim)
            rc, grc = p3["regular_conv"], g3["regular_conv"]
            d3 = deform.deform_conv2d(x3in, off, rc["w"], rc.get("b"))
            compare("  its deformable conv, given the offsets",
                    deform.deform_conv2d(c(x3in), c(off), grc["w"],
                                         grc.get("b")), d3)
            b3 = nn.batch_norm(cp["block3"]["bn1"], d3)
            compare("  its batch norm",
                    nn.batch_norm(gp["block3"]["bn1"], c(d3)), b3)
            compare("  its SELU", nn.selu(c(b3)), nn.selu(b3))
        x4in = nn.avg_pool(x3, 4)
        x4 = al._res_block(cp["block4"], x4in, True)
        compare("block 4 (deformable)",
                al._res_block(gp["block4"], c(x4in), True), x4)
        ys = [y1]
        for i, xi in ((2, x2), (3, x3), (4, x4)):
            y = al._branch(cp[f"conv{i}"], xi)
            compare(f"branch conv{i}", al._branch(gp[f"conv{i}"], c(xi)), y)
            ys.append(y.permute(0, 2, 3, 1).contiguous())
        parts = al._score_parts(cp["score_head"], ys, True)
        score = al._score_tail(cp["score_head"], parts, False, True, True)
        compare("score head (1x1 parts and tail)", al._score_tail(
            gp["score_head"], al._score_parts(gp["score_head"],
                                              [c(y) for y in ys], True),
            False, True, True), score)
        print("convolutions against their exact sums:")
        against_exact("block 2 conv1 (3x3)", gp["block2"]["conv1"]["w"],
                      c(x1p))
        against_exact("branch conv2 (1x1)", gp["conv2"]["w"], c(x2))
        against_exact("block 3 offset conv (3x3)",
                      g3["offset_conv"]["w"], c(x3in))
        against_exact("block 3 downsample (1x1)",
                      gp["block3"]["downsample"]["w"], c(x3in))
        print("the score map:")
        whole = al._dense_branches(gp, c(x), False, True)[1]
        compare("whole chain", whole, score)
        with km.deformable_blocks(outputs=(x3, x4)):
            spliced = al._dense_branches(gp, c(x), False, True)[1]
        compare("blocks 3 and 4 from the CPU", spliced, score)


if __name__ == "__main__":
    main()
