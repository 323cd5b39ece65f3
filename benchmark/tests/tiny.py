"""Small widths for running the harness on the CPU: every shape of the
configurations cut down, the codec random from the seed."""

from __future__ import annotations

import copy

PRIOR = {
    "variance_adaptor": {
        "sigma_min": 1e-4,
        "duration_generator": {"input_size": 16, "filter_size": 24, "kernel_size": 3, "time_scale": 2,
                               "drop_out": 0.0},
        "sil_generator": {"input_size": 16, "filter_size": 24, "kernel_size": 3, "time_scale": 2,
                          "drop_out": 0.0},
    },
    "transformer": {
        "encoder_layer": 1, "encoder_head": 2, "encoder_hidden": 16, "encoder_conv_filter_size": 32,
        "encoder_conv_kernel_size": [9, 1], "encoder_dropout": 0.0, "encoder_max_seq_len": 4096,
        "decoder_shared_layers": 1, "decoder_layers": [1, 1, 1, 1, 1, 1], "decoder_head": 2,
        "decoder_hidden": 24, "decoder_conv_filter_size": 48, "decoder_conv_kernel_size": [3, 1],
        "decoder_dropout": 0.0, "decoder_max_seq_len": 8192,
    },
    "codec": {"vocab_size": 1024, "n_quantizers": 6},
}
PROB = {"target_dim": 256, "spk_dim": 256, "cond_dim": 24, "downsampling_stages": 1, "hidden_dim": 32,
        "n_layers": 1, "n_quantizers": 6, "sigma_min": 1e-6,
        "convnext": {"kernel_size": 31, "stride": 1, "padding": 15, "expand": 1, "groups": None}}
CODEC = {
    "weights": None, "sr": 16000,
    "encoder": {"ngf": 8, "up_ratios": [2, 4, 5, 5], "out_channels": 256},
    "decoder": {"in_channels": 256, "upsample_initial_channel": 64, "up_ratios": [5, 5, 4, 2],
                "vq_num_q_p": 1, "vq_num_q_c": 2, "vq_num_q_r": 3, "vq_dim": 256, "codebook_dim": 8,
                "codebook_size": 1024},
    "timbre": {"layers": 1, "heads": 4, "ffn": 64, "kernel": 5},
}
BUCKETS = {"phoneme": [16, 32], "frame": [64, 128, 256], "prompt": [64, 128, 256]}


def overrides(workload: str) -> dict:
    """The configuration and mix keys that make ``workload`` small."""
    if workload == "facodec_roundtrip":
        return {"config": {"codec": copy.deepcopy(CODEC)},
                "mix": {"seconds": {"min": 0.3, "max": 1.6, "median": 0.6, "sigma": 0.6, "levels": 4},
                        "pool": 4, "check_sample": 3}}
    return {"config": {"prior_generator": copy.deepcopy(PRIOR), "prob_generator": copy.deepcopy(PROB),
                       "codec": copy.deepcopy(CODEC), "buckets": copy.deepcopy(BUCKETS)},
            "mix": {"phonemes": {"min": 10, "max": 16}, "prompt_seconds": 1.0, "nfe": [3, 3],
                    "speakers": 2, "max_calls_per_second": 4, "check_sample": 3, "warmup_passes_max": 1,
                    "budget_max": 9.0}}
