"""Convert the VinVL checkpoint (vinvl_vg_x152c4.pth) to the .npz checkpoint
both packages read (port of tools/convert_vinvl.py):

    python -m nl_vsgg_tpu_torch.tools.convert_vinvl in.pth out.npz

The file holds the JAX package's flat '/'-joined keys and arrays
(`detector.convert.save_npz`); `detector.convert.load_checkpoint` reads it
back into the port's state_dict.
"""

from __future__ import annotations

import sys

from ..detector.convert import load_checkpoint, save_npz


def main(argv=None) -> int:
    src, dst = (sys.argv[1:] if argv is None else argv)[:2]
    n = save_npz(load_checkpoint(src), dst)
    print(f"wrote {n} arrays -> {dst}")
    return n


if __name__ == "__main__":
    main()
