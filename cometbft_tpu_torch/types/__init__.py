"""Commit, votes, validator sets and commit verification."""
