"""Configurations: the paper's 12-app suite (:mod:`.paper_suite`). The
model-architecture configs arrive with ROADMAP §1.11."""
