from svbfm.models.fm import FMParams, fm_predict, init_fm_params  # noqa: F401
