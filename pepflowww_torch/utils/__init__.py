"""Run-directory, logging and metric helpers for the command-line tools."""
