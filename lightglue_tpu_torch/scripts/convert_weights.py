"""Convert a reference PyTorch checkpoint to the flat npz of the JAX
package's layout (counterpart of scripts/convert_weights.py, with its
command line):

    python lightglue_tpu_torch/scripts/convert_weights.py lightglue superpoint_lightglue.pth out.npz
    python lightglue_tpu_torch/scripts/convert_weights.py superpoint superpoint_v1.pth out.npz
    python lightglue_tpu_torch/scripts/convert_weights.py aliked aliked-n16.pth out.npz
    python lightglue_tpu_torch/scripts/convert_weights.py hardnet checkpoint_liberty_with_aug.pth out.npz
    python lightglue_tpu_torch/scripts/convert_weights.py disk depth-save.pth out.npz

``--features`` names the matcher's preset (input_dim, add_scale_ori). The
state dict goes through the port's converters (every key and shape
checked; ALIKED's model found from its widths) and ``weights.to_jax_params``
into ``weights.save_params``: the npz that both packages' ``load_params``,
``params=`` and ``fetch`` read. A checkpoint wrapped as the release files
are (DISK's ``extractor``, HardNet's ``state_dict``) is unwrapped with its
registry entry's keys. To let ``pretrained=True`` find the file, write it
as ``weights/<registry name>.npz`` (or drop the ``.pth`` there under that
name, which ``weights.fetch`` converts).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from lightglue_tpu_torch import weights as W  # noqa: E402
from lightglue_tpu_torch.configs import ALIKEDConfig, lightglue_config  # noqa: E402

# model -> the registry entry whose unwrap keys its checkpoint takes
_ENTRY = {"lightglue": "superpoint_lightglue", "superpoint": "superpoint_v1",
          "aliked": "aliked-n16", "hardnet": "hardnet_liberty_aug",
          "disk": "disk_depth"}


def aliked_model_name(sd) -> str:
    """The ALIKED model whose widths fit every tensor of ``sd`` (aliked-n16
    and aliked-n16rot share one layout: the first is named)."""
    for name in ("aliked-t16", "aliked-n16", "aliked-n32"):
        entries = W.aliked_entries(ALIKEDConfig(model_name=name))
        if all(key in sd and tuple(sd[key].shape) == shape
               for _, key, shape in entries):
            return name
    raise ValueError("the state dict fits no ALIKED model's widths")


def convert(model: str, sd, features: str = "superpoint"):
    """The port's parameter tree of a reference state dict."""
    if model == "lightglue":
        return W.from_state_dict(sd, lightglue_config(features))
    if model == "aliked":
        return W.aliked_from_state_dict(
            sd, ALIKEDConfig(model_name=aliked_model_name(sd)))
    return {"superpoint": W.superpoint_from_state_dict,
            "hardnet": W.hardnet_from_state_dict,
            "disk": W.disk_from_state_dict}[model](sd)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=list(_ENTRY))
    ap.add_argument("checkpoint", help=".pth state dict path")
    ap.add_argument("output", help="output .npz path")
    ap.add_argument("--features", default="superpoint",
                    help="lightglue preset (sets input_dim/add_scale_ori)")
    args = ap.parse_args(argv)

    obj = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    sd = W._unwrap_state_dict(obj, W.REGISTRY[_ENTRY[args.model]].unwrap)
    flat = W.to_jax_params(convert(args.model, sd, args.features))
    W.save_params(args.output, flat)
    print(f"wrote {args.output}: {len(flat)} arrays")


if __name__ == "__main__":
    main()
