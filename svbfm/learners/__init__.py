from svbfm.learners.base import FMConfig, RowData, PlanData, build_row_data, build_plan_data  # noqa: F401
