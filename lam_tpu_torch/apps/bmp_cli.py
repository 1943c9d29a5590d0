"""`python -m lam_tpu_torch.apps.bmp_cli`: the grid-to-image converter of
lam_tpu/apps/bmp_cli.py (`lam-heat-to-bmp`), numpy only.

Positional args `input_file.bin output_file.bmp`, defaults
`io/heat.bin io/heat.bmp`, 0..100 temperature range unless --min-temp /
--max-temp say otherwise.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    """Entry point: I/O and argument errors print one line to stderr and
    return 1, as lam_tpu's does."""
    try:
        return _cli_main(argv)
    except (OSError, ValueError) as e:
        print(f"lam-heat-to-bmp: {e}", file=sys.stderr)
        return 1


def _cli_main(argv=None):
    p = argparse.ArgumentParser(prog="lam-heat-to-bmp-torch")
    p.add_argument("input_file", nargs="?", default="io/heat.bin")
    p.add_argument("output_file", nargs="?", default="io/heat.bmp")
    p.add_argument("--min-temp", type=float, default=0.0)
    p.add_argument("--max-temp", type=float, default=100.0)
    args = p.parse_args(argv)

    from lam_tpu_torch import io as lio
    from lam_tpu_torch.apps import bmp

    print("Loading input grid ...")
    grid = lio.read_matrix(args.input_file)  # (ny, nx)
    print("Done\n")

    print("Converting grid to image ...")
    rgb = bmp.colormap(grid, args.min_temp, args.max_temp)
    print("Done\n")

    print("Writing image to file ...")
    bmp.write_bmp(args.output_file, rgb)
    print("Done\n")
    print("Finished successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
