"""Host utilities: profiling and seeding, the dataset analyzer, the step's roofline model."""
