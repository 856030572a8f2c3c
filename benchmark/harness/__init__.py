"""The benchmark's own code: traffic, weights, yardsticks, the trace
reduction and the comparisons that decide ``correct``. Nothing here
imports the program; the drivers under ``benchmark/drivers/`` do."""
