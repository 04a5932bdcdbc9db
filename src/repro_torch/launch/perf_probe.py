"""Perf-loop probe: ``dryrun`` with the JAX package's perf-probe defaults
(``--tag probe``, ``--out dryrun_perf.jsonl``), under its arguments.

  PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch smollm-135m \
      --shape train_4k --override shard_policy=dp --tag dp_only --breakdown

Every other argument is ``dryrun``'s. The breakdown lists every collective
as the step issued it: the port's layer loops are Python loops, and nothing
appears once for many runs.
"""
import sys

from repro_torch.launch import dryrun


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # argparse keeps an option's last value: the caller's wins
    return dryrun.main(["--tag", "probe", "--out", "dryrun_perf.jsonl",
                        *argv])


if __name__ == "__main__":
    sys.exit(main())
