from .partition import (Sharding, batch_spec, distribute, param_shardings,
                        param_specs, placements_for, spec_for_path)

__all__ = ["param_specs", "param_shardings", "batch_spec", "spec_for_path",
           "Sharding", "placements_for", "distribute"]
