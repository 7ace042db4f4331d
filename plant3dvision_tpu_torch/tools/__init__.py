"""Command-line probes of the port (`python -m plant3dvision_tpu_torch.tools.<name>`)."""
