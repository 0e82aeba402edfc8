from .iterative import (
    IterativeSparseSolver,
    CGIterativeSparseSolver,
    FGMRESIterativeSparseSolver,
    ConvergenceWarning,
    cg,
    cg_mrhs,
    fgmres,
)
from .pardiso import (
    pardiso,
    pardisoinit,
    export_factorization,
    import_factorization,
)
from .qr import sparse_qr_solver

__all__ = [
    "IterativeSparseSolver",
    "CGIterativeSparseSolver",
    "FGMRESIterativeSparseSolver",
    "ConvergenceWarning",
    "cg",
    "cg_mrhs",
    "fgmres",
    "pardiso",
    "pardisoinit",
    "export_factorization",
    "import_factorization",
    "sparse_qr_solver",
]
