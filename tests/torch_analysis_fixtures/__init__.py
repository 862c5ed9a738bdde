"""Seeded-violation fixtures for the port's contract checker
(``repro_torch.analysis``), the torch forms of tests/analysis_fixtures.

Every module here intentionally violates one contract or lint rule;
tests/test_torch_analysis.py asserts the corresponding rule FIRES on it.
None of this code is imported by the library.
"""
