"""User-facing tools: the pipeline orchestrator and the CLI."""
