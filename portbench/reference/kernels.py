"""Frozen table of device operation names: which kernels a per-layer metric
files under a layer.  Patterns are regular expressions searched in the
profiler's kernel names.

* K1, the frontend kernel (``tpumix_torch/csrc/stft_dif.cu``): ``dif_kernel``.
* The model's trunk and heads: every convolution and GEMM kernel (cuDNN's,
  its FFT convolutions' transforms and products included, cuBLAS's,
  CUTLASS's, and the port's ``conv_block`` kernels in
  ``csrc/conv_block.cu``), and every other cuDNN kernel (its inference
  BatchNorm and layout conversions).  Elementwise ReLU and residual adds are not counted, nor
  (being no convolution of the model) is any other kernel; the epilogue's
  Savitzky-Golay ``conv1d`` is counted, a few microseconds a song.
"""

K1 = r"dif_kernel"
TRUNK = (r"conv(?!ert)|gemm|gemv|xmma|winograd|implicit|cudnn|nhwcToNchw|nchwToNhwc|bn_fw|"
         r"fft|pointwise_mult_and_sum_complex|flip_filter|conv_block")
