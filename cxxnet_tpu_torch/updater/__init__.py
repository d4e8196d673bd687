"""Per-weight optimizers and learning-rate / momentum schedules."""

from .updaters import (UpdaterHyper, apply_updates,  # noqa: F401
                       create_updater_hyper, init_opt_state)
