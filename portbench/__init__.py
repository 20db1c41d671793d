"""The benchmark of ``atray_tpu_torch``; see ``portbench/README.md``."""
