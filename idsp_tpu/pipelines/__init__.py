"""End-to-end DSP pipelines (the reference's examples)."""
