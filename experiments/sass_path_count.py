"""Count the SASS instructions one trip of a loop executes along a path.

    python experiments/sass_path_count.py FILE HEAD:BACK [SKIP_FROM:SKIP_TO ...]
        [--warps W --trips N --clock-mhz F --sms S]

FILE is the SASS of one function as `cuobjdump -sass` prints it (the
`--sass` option of experiments/torch_step_kernel_timing.py writes one file
a function). HEAD:BACK are the hex addresses of the loop's first
instruction (its back branch's target) and of its back branch; each
SKIP_FROM:SKIP_TO is a range of addresses the path does not execute: the
instructions a taken forward branch jumps over (an arm of a uniform branch,
a slow path of sqrtf, sinf or cosf). Prints the instructions on the path
and, with --warps and --trips, the issue floor they set: warp instructions
over (SMs x 4 schedulers x the SM clock), one instruction a cycle a
scheduler. Every instruction is 16 bytes on sm_90.
"""

import argparse
import re


def addresses(path):
    out = []
    for line in open(path):
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+\S", line)
        if m:
            out.append(int(m.group(1), 16))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("file")
    ap.add_argument("loop")
    ap.add_argument("skips", nargs="*")
    ap.add_argument("--warps", type=int)
    ap.add_argument("--trips", type=int)
    ap.add_argument("--clock-mhz", type=float, default=1980.0)
    ap.add_argument("--sms", type=int, default=132)
    args = ap.parse_args()
    head, back = (int(x, 16) for x in args.loop.split(":"))
    skips = [tuple(int(x, 16) for x in s.split(":")) for s in args.skips]
    path = [a for a in addresses(args.file)
            if head <= a <= back and not any(lo <= a <= hi for lo, hi in skips)]
    print(f"{len(path)} instructions on the path of one trip "
          f"({(back - head) // 16 + 1} in the loop's span)")
    if args.warps and args.trips:
        ms = args.warps * args.trips * len(path) / (args.sms * 4 * args.clock_mhz * 1e6) * 1e3
        print(f"issue floor for {args.warps} warps x {args.trips} trips: {ms:.4f} ms at "
              f"{args.clock_mhz:.0f} MHz on {args.sms} SMs")


if __name__ == "__main__":
    main()
