"""The yardstick: a frozen copy of the peaks, of K1's operation and byte
counts and of the analytic step operations. Later changes to the program
do not change it."""
