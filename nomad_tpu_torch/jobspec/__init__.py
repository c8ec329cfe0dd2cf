"""Jobspec parsing: HCL text → `structs.Job`.

Behavioral reference: `jobspec/parse.go:26` (`Parse(io.Reader)
(*api.Job, error)`) and the per-section parsers (`parse_job.go`,
`parse_group.go`, `parse_task.go`, `parse_network.go`, `parse_service.go`).
The reference parses into its `api` model and the agent converts to
`structs`; this build has one model, so parsing lands on `structs.Job`
directly.
"""
from .parse import parse, parse_file
from .hcl import HclError, parse_hcl

__all__ = ["HclError", "parse", "parse_file", "parse_hcl"]
