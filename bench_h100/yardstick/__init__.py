"""The benchmark's yardstick: peaks, operation and byte counts, the kernel
name table. Frozen copies that later changes to the program cannot move."""
