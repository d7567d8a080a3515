from setuptools import find_packages, setup

setup(
    name="tpumix",
    version="0.1.0",
    description="TPU-native automatic multitrack mixing framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests",)),
    # the PyTorch port builds its CUDA kernels and its WAV reader from these
    # sources at first use
    package_data={"tpumix_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    python_requires=">=3.10",
)
