"""Jet primitives, determinants and the hand-written CUDA kernels of the port."""

from __future__ import annotations


def launch_counts() -> dict:
    """Each kernel wrapper's launch counter, and those of the card-specific kernels."""
    from deephall_tpu_torch.ops import jet_attention as ja
    from deephall_tpu_torch.ops import jet_layernorm as jl
    from deephall_tpu_torch.ops import orbital_head as oh

    return {
        "jet_layernorm": jl.layernorm_jet.launches,
        "jet_attention": ja.attention_jet.launches,
        "jet_gemm": ja.jet_gemm.launches,
        "jet_softmax_values": ja.softmax_values.launches,
        "jet_gemm_tensor_core": ja.jet_gemm.launches_tensor_core,
        "jet_softmax_values_tiled": ja.softmax_values.launches_tiled,
        "jet_layernorm_streamed": jl.layernorm_jet.launches_streamed,
        "jet_layernorm_staged": jl.layernorm_jet.launches_staged,
        "orbital_head": oh.orbital_matrices_jet.launches,
    }


def reset_launch_counts() -> None:
    """Every counter of :func:`launch_counts` to 0."""
    from deephall_tpu_torch.ops import jet_attention as ja
    from deephall_tpu_torch.ops import jet_layernorm as jl
    from deephall_tpu_torch.ops import orbital_head as oh

    for fn in (jl.layernorm_jet, ja.attention_jet, ja.jet_gemm, ja.softmax_values,
               oh.orbital_matrices_jet):
        fn.launches = 0
    ja.jet_gemm.launches_tensor_core = 0
    ja.softmax_values.launches_tiled = 0
    jl.layernorm_jet.launches_streamed = 0
    jl.layernorm_jet.launches_staged = 0
