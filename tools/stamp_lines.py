"""Run a command and prefix each line of its standard output with the
seconds since the command started, to see where a long run such as
``chip_smoke.py`` spends its time without changing what it prints:

    python3 tools/stamp_lines.py python3 chip_smoke.py > smoke.log

Standard error passes through unchanged; the exit code is the command's."""

import subprocess
import sys
import time


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, bufsize=1) as proc:
        for line in proc.stdout:
            sys.stdout.write(f"[{time.perf_counter() - t0:8.1f}] {line}")
            sys.stdout.flush()
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
