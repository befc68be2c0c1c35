"""The yardstick's constants: one NVIDIA H100 SXM's published peaks and the
names of the port's hand kernels.

Peaks are NVIDIA's data sheet's dense rates at the card's full 700 W.
``MFU_PEAK`` is the dense bf16 rate that every step's share of the chip is
taken against. A kernel's roofline takes the rate of its operands' type:
bf16 operands 989 TFLOP/s; f32 operands 495 TFLOP/s, TF32's rate, the
fastest at which the card multiplies f32 inputs (a kernel that runs three
TF32 passes can therefore not read above 100 %).

``KERNEL_GROUPS`` is a frozen copy of the ``__global__`` functions of the
port's ``csrc/*.cu`` files (``ops/cuda.py::KERNEL_FUNCTIONS``), grouped by
the layer whose roofline they make.
"""

MFU_PEAK = 989.4e12  # FLOP/s, dense bf16
PEAK_FLOPS = {"bfloat16": 989.0e12, "float32": 495.0e12}
HBM_BYTES_PER_S = 3.35e12

KERNEL_GROUPS = {
    # csrc/band_conv.cu (forward and d_feats) and csrc/band_conv_bwd.cu (d_w)
    "band_conv": ("split_weights_kernel", "band_conv_kernel",
                  "band_conv_bwd_kernel"),
    # csrc/window_attention.cu and csrc/window_attention_bwd.cu
    "attention": ("window_attention_kernel", "dq_kernel", "dk_dv_kernel"),
}

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
