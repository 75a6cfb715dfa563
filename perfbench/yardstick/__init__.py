"""What measures and what it measures against: the card's peaks, the
reduction of a profiler trace, the device facts of a result, the import
check and the loading of the benchmark's files."""
