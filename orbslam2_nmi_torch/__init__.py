"""PyTorch + CUDA port of `orbslam2_nmi_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; every ported module keeps
the relative path of its counterpart there (`ops/`, `io/`, `geometry/`,
`solvers/`, `slam/`). This
package imports neither `jax` nor `orbslam2_nmi_tpu`, and importing it changes
no process-wide setting: geometry stays in full float32 and TF32 stays off.

Hand-written CUDA kernels live in `csrc/` and are built on first use by
`kernels.py`. Each kernel's wrapper launches it for CUDA tensors and runs its
plain PyTorch version, kept in the same module, for CPU tensors only.
`kernel_cases.py` holds adversarial inputs for checking kernels against
their plain versions; `tools/ablate_kernels.py` times kernel ablations.
"""
