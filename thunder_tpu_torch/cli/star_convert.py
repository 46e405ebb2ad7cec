"""STAR <-> .thu converters (reference script/STAR_2_THU.py,
THU_2_STAR.py), as thunder_tpu.cli.star_convert; host only:

    python -m thunder_tpu_torch.cli.star_convert star2thu -i run_data.star -o particles.thu
    python -m thunder_tpu_torch.cli.star_convert thu2star -i meta.thu -o out.star
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="star_convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("star2thu")
    s.add_argument("-i", required=True)
    s.add_argument("-o", required=True)
    s = sub.add_parser("thu2star")
    s.add_argument("-i", required=True)
    s.add_argument("-o", required=True)
    s.add_argument("--pixelsize", type=float, default=1.0)
    a = p.parse_args(argv)

    from thunder_tpu_torch.io.star import star_to_thu, thu_to_star
    from thunder_tpu_torch.io.thu import read_thu, write_thu

    if a.cmd == "star2thu":
        write_thu(a.o, star_to_thu(a.i))
    else:
        thu_to_star(a.o, read_thu(a.i), a.pixelsize)
    return 0


if __name__ == "__main__":
    sys.exit(main())
