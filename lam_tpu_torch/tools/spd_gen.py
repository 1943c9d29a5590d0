"""`lam-spd-gen-torch`: the random SPD system generator, as lam_tpu's
`lam-spd-gen` (lam_tpu/tools/spd_gen.py:1-80).

    lam-spd-gen-torch [size] [output_file_matrix] [output_file_rhs] [seed]
        [--fast]

Positional arguments as the reference's offline tool
(random_spd_system.cpp:127-196): defaults `10 io/matrix.bin io/rhs.bin
<time>`. A = (Q sqrt(D)) (Q sqrt(D))^T with D = exp(3.5 * U(-1, 1))
(random_spd_system.cpp:66-101); --fast, or a size above 4096, takes the
spectrum-exact O(k N^2) Householder construction
(`lam_tpu_torch.generate.random_spd_system`).

This tool runs on the host and takes no --device: its contract is the
bytes of the reference's binary format, the same for the same arguments
as lam_tpu's tool (pure numpy, lam_tpu/tools/spd_gen.py:57-62), and a
device build would round the Householder products differently.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    """Entry point: I/O and argument errors become one stderr line and
    exit code 1, as lam_tpu's (the reference never shows a backtrace on
    a missing or corrupt file)."""
    try:
        return _cli_main(argv)
    except (OSError, ValueError) as e:
        print(f"lam-spd-gen: {e}", file=sys.stderr)
        return 1


def _cli_main(argv=None):
    p = argparse.ArgumentParser(
        prog="lam-spd-gen",
        description="Generate a random SPD system in the reference "
                    "binary format")
    p.add_argument("size", nargs="?", type=int, default=10)
    p.add_argument("output_file_matrix", nargs="?", default="io/matrix.bin")
    p.add_argument("output_file_rhs", nargs="?", default="io/rhs.bin")
    p.add_argument("seed", nargs="?", type=int, default=int(time.time()))
    p.add_argument("--fast", action="store_true",
                   help="spectrum-exact O(N^2) construction for large N")
    args = p.parse_args(argv)

    if args.size <= 0:
        print("Wrong argument value", file=sys.stderr)
        return 1

    print("Command line arguments:")
    print(f"  matrix_size:        {args.size}")
    print(f"  output_file_matrix: {args.output_file_matrix}")
    print(f"  output_file_rhs:    {args.output_file_rhs}")
    print(f"  seed:               {args.seed}")
    print("")

    from lam_tpu_torch import generate as gen
    from lam_tpu_torch import io as lio

    print("Generating the matrix ...")
    fast = args.fast or args.size > 4096
    a, b = gen.random_spd_system(args.size, seed=args.seed, fast=fast)
    print("Done\n")

    print("Writing matrix to file ...")
    lio.write_matrix(args.output_file_matrix, a)
    print("Done\n")

    print("Writing right hand side to file ...")
    lio.write_matrix(args.output_file_rhs, b)
    print("Done\n")

    print("Finished successfully")
    return 0


if __name__ == "__main__":
    sys.exit(main())
