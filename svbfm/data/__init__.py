from svbfm.data.dataset import SparseDataset, SweepPlan  # noqa: F401
from svbfm.data.libfm_text import load_libfm_text, save_libfm_text  # noqa: F401
from svbfm.data.meta import DataMetaInfo  # noqa: F401
