"""CLI entry points with the reference binaries' names and argument shapes.

Each module exposes main(argv) and is runnable via
`python -m slam3d_gx.cli.<name>`; the repo-root `bin/` wrappers give the
exact reference binary names (SURVEY.md §2.1).
"""
