"""Ops of the port. Each kernel module holds its CUDA wrapper, its plain
PyTorch version and its ``KERNEL`` (build + launch count)."""

__all__ = ["all_kernels"]


def all_kernels():
    """The port's CUDA kernel libraries, for building and launch counts:
    K1, K2, K3, K4 (paged writes), K5 / K6 (paged attention, one
    library), K7 (dense-cache decode attention), K8 (grouped MoE GEMM),
    K4q (INT8 paged writes), K5q / K6q (INT8 paged attention, one
    library), K9 (small-group W4A16 GEMM), K10 / K10q (paged MLA decode
    attention over bf16 or INT8 latent pages, one library), K11 / K11f
    (W4A8 GEMM, one library), K12 (grouped W4A8 MoE GEMM), K13
    (RMSNorm) and K14 (the decode layer tail)."""
    from quick_tpu_torch.ops.decode_attention import KERNEL as K7
    from quick_tpu_torch.ops.flash_attention import KERNEL as K2
    from quick_tpu_torch.ops.fused_layer_tail import KERNEL as K14
    from quick_tpu_torch.ops.fused_decode_step import KERNEL as K3
    from quick_tpu_torch.ops.grouped_matmul import KERNEL as K8
    from quick_tpu_torch.ops.grouped_matmul import KERNEL_A8 as K12
    from quick_tpu_torch.ops.mla_paged_attention import KERNEL as K10
    from quick_tpu_torch.ops.paged_attention import KERNEL as K56
    from quick_tpu_torch.ops.paged_attention import KERNEL_INT8 as K56q
    from quick_tpu_torch.ops.paged_write import KERNEL as K4
    from quick_tpu_torch.ops.paged_write import KERNEL_INT8 as K4q
    from quick_tpu_torch.ops.norms import KERNEL as K13
    from quick_tpu_torch.ops.quantized_matmul import KERNEL as K1
    from quick_tpu_torch.ops.quantized_matmul import KERNEL_A8 as K11
    from quick_tpu_torch.ops.quantized_matmul import KERNEL_DEQUANT as K9

    return [K1, K2, K3, K4, K56, K7, K8, K4q, K56q, K9, K10, K11, K12, K13, K14]
