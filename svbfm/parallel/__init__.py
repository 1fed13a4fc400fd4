from svbfm.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    FEATURE_AXIS,
    make_mesh,
    make_mesh2d,
)

# Feature-sharded (tensor-parallel) training lives in tp_vb / tp_mcmc;
# imported lazily by users to keep `import svbfm` light:
#   from svbfm.parallel.tp_vb import TPVBLearner
#   from svbfm.parallel.tp_mcmc import TPMCMCLearner, TPALSLearner
