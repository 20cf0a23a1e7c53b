"""Hand-written CUDA kernels: the Nyström solver's p-streaming passes and
the transformer's RMSNorm and attention.

csrc/atb.cu              kernel A: AᵀB (gram CᵀC and the m-query cross CᵀV),
                         bf16 on the tensor cores (TMA + wgmma) or IEEE f32
                         on the CUDA cores
csrc/ctv.cu              kernel B: Cᵀv
csrc/woodbury_apply.cu   kernel C: V/ρ − C W/ρ², any m ≥ 1, ρ at run time
csrc/rmsnorm.cu          kernel D: row RMSNorm
csrc/flash_attention.cu  kernel E: attention forward (online softmax),
                         bf16 on the tensor cores (TMA + wgmma) or f32
                         arithmetic on the CUDA cores
csrc/hopper.cuh          mbarrier, TMA and wgmma helpers of kernels A and E

nystrom_gram.py / woodbury.py /
rmsnorm.py / flash_attention.py  wrappers (checks, launch, launch counters)
ops.py                           public wrappers + the composed Eq. 6 apply
ref.py                           plain PyTorch versions (CPU path, ground truth)
_lib.py                          nvcc build, ctypes binding, LAUNCHES

Sources are compiled at first use, never when a module is imported.
"""
