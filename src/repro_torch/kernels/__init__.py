"""Hand-written CUDA kernels for the Nyström solver's p-streaming passes.

csrc/atb.cu             kernel A: AᵀB (gram CᵀC and the m-query cross CᵀV)
csrc/ctv.cu             kernel B: Cᵀv
csrc/woodbury_apply.cu  kernel C: V/ρ − C W/ρ², any m ≥ 1, ρ at run time

nystrom_gram.py / woodbury.py  wrappers (checks, launch, launch counters)
ops.py                         public wrappers + the composed Eq. 6 apply
ref.py                         plain PyTorch versions (CPU path, ground truth)
_lib.py                        nvcc build, ctypes binding, LAUNCHES

Sources are compiled at first use, never when a module is imported.
"""
