#!/usr/bin/env python
"""Train with the PyTorch port: ``python train_torch.py -c <yaml> [-t]``.

The counterpart of ``train.py`` for fithubert_tpu_torch, on the reference's
YAML schema: ``-c`` the config (reading it needs PyYAML), ``-t`` evaluate
on ``data.test_set`` only, ``--no-resume`` ignore existing checkpoints,
``--device`` ``cuda`` (the default) or ``cpu`` (the kernels' plain PyTorch
versions).

Alone, it trains on ``train.num_devices`` of the visible cards (0 = all of
them; ``gpus`` in the YAML): one card in this process, or more, one spawned
rank each, data parallel over NCCL. Under torchrun each process is one rank:

    torchrun --nproc_per_node=2 train_torch.py -c configs/fithubert.yaml
    python -m torch.distributed.run --nproc_per_node=2 train_torch.py \
        -c configs/smoke.yaml --device cpu       # two gloo ranks on the CPU
"""

import argparse


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
    args = parser.parse_args(argv)

    from fithubert_tpu_torch.config import load_experiment_yaml
    from fithubert_tpu_torch.train.loop import run_training

    result = run_training(load_experiment_yaml(args.config), resume=not args.no_resume,
                          test_only=args.test, device=args.device)
    print(result)
    return result


if __name__ == "__main__":
    main()
