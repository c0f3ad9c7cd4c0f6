from repro_torch.configs.base import (ARCH_IDS, ArchConfig, ShapeSpec, SHAPES,
                                      get_config, registry, shapes_for)
