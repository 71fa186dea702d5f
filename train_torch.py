#!/usr/bin/env python
"""Train with the PyTorch port: ``python train_torch.py -c <yaml> [-t]``.

The counterpart of ``train.py`` for fithubert_tpu_torch, on the reference's
YAML schema: ``-c`` the config (reading it needs PyYAML), ``-t`` evaluate
on ``data.test_set`` only, ``--no-resume`` ignore existing checkpoints,
``--device`` ``cuda`` (the default) or ``cpu`` (the kernels' plain PyTorch
versions), ``--set section.key=value`` (repeatable) a YAML value over
the file's, e.g. ``--set data.synthetic=true``.

Alone, it trains on ``train.num_devices`` of the visible cards (0 = all of
them; ``gpus`` in the YAML): one card in this process, or more, one spawned
rank each, data parallel over NCCL. Under torchrun each process is one rank:

    torchrun --nproc_per_node=2 train_torch.py -c configs/fithubert.yaml
    python -m torch.distributed.run --nproc_per_node=2 train_torch.py \
        -c configs/smoke.yaml --device cpu       # two gloo ranks on the CPU
    python train_torch.py -c configs/ex.yaml --device cpu --set data.synthetic=true \
        --set data.synthetic_wav_length=32000 --set train.max_steps=4
"""

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "-cfg", "--config", default="configs/smoke.yaml",
                        help="yaml config path for training")
    parser.add_argument("-t", "--test", action="store_true", help="Enable testing mode")
    parser.add_argument("--no-resume", action="store_true",
                        help="Ignore existing checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; a rank's own card under torchrun) or cpu; "
                             "nothing falls back to the CPU by itself")
    parser.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                        help="override one field of the YAML (the value read as YAML)")
    args = parser.parse_args(argv)

    import yaml

    from fithubert_tpu_torch.config import config_from_yaml_dict, read_yaml
    from fithubert_tpu_torch.train.loop import run_training

    raw = read_yaml(args.config)
    for item in args.set:
        name, sep, value = item.partition("=")
        section, dot, key = name.partition(".")
        if not (sep and dot and section and key):
            parser.error(f"--set wants SECTION.KEY=VALUE, got {item!r}")
        raw[section] = {**(raw.get(section) or {}), key: yaml.safe_load(value)}
    result = run_training(config_from_yaml_dict(raw), resume=not args.no_resume,
                          test_only=args.test, device=args.device)
    # one write of the whole line: under torchrun every rank prints its
    # result to the same file, and print's separate newline could interleave
    sys.stdout.write(f"{result}\n")
    sys.stdout.flush()
    return result


if __name__ == "__main__":
    main()
