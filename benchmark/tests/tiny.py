"""Cells of the benchmark's configurations cut to a size the CPU runs in
seconds (widths, depths, lengths): for the tests only."""

from __future__ import annotations

import copy
import json
import os

from benchmark import harness, traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cell(kind: str = "fithubert", fp16: bool = True, mix: str = "train_graphed",
              name: str = None) -> harness.Cell:
    with open(os.path.join(HERE, "configs", f"{kind}.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    g = cfg["teacher_geometry"]
    g.update(conv_feature_layers=[[32, 10, 5], [32, 3, 2], [32, 2, 2]], encoder_embed_dim=64,
             encoder_ffn_embed_dim=128, encoder_layers=4, encoder_attention_heads=4, conv_pos=8,
             conv_pos_groups=4)
    exp = cfg["experiment"]
    exp["teacher"].update(encoder_layers=4, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                          encoder_attention_heads=4)
    d = exp["distiller"]
    if kind == "fithubert":
        d.update(conv_feature_layers=[[32, 10, 5], [32, 3, 2], [64, 2, 2]], encoder_embed_dim=48,
                 encoder_ffn_embed_dim=48, encoder_attention_heads=4, encoder_layers=3,
                 conv_pos=8, conv_pos_groups=4, pred_head_final_dim=64)
        exp["train"]["distil_random_layer"] = 2
    else:
        d.update(conv_feature_layers=[[64, 10, 5], [64, 3, 2], [64, 2, 2]], encoder_embed_dim=64,
                 encoder_ffn_embed_dim=128, encoder_attention_heads=4, encoder_layers=2,
                 conv_pos=8, conv_pos_groups=4, pred_head_final_dim=64, pred_layer_id=[1, 2, 3])
    exp["train"].update(use_fp16=fp16, batch_size=2, accumulate_grad_batches=2)
    exp["data"]["max_wav_length"] = 4000
    cfg.update(num_training_steps=1000, start_step=50)
    mix_d = dict(traffic.load_mix(mix), pool_steps=3, pool_calls=3, batch=4, sample_calls=2)
    lengths = {"sample_rate": 16000, "amplitude": 0.1,
               "mixture": [{"weight": 0.85, "low_s": 0.16, "high_s": 0.3},
                           {"weight": 0.15, "low_s": 0.05, "high_s": 0.16}]}
    cell_name = name or f"{kind}.{'train' if mix == 'train_graphed' else 'serve'}"
    return harness.Cell(cell_name, {"name": cell_name, "chips": 1}, cfg, mix_d, lengths)
